// K1 and K7: fused FISTA extrapolation + joint TV / TGV2 gradient, for
// Hopper.
//
// K1 replaces the Pallas kernel jpeg2png_tpu/kernels/grad_step.py::fused_grad
// (_kernel, _stencil_terms); K7 replaces
// jpeg2png_tpu/kernels/stripe_grad.py::fused_grad_striped (_kernel).  Both
// compute, for all C channels of a band of L rows of an f32 canvas whose
// first row is global row row0 (reference: compute.c:73-197, 427-440):
//
//   e      = f + factor * (f - fista)
//   gx, gy = forward differences of e (zero on the last true col / row)
//   grad   = alpha * TV gather + alpha2 * TGV2 gather, zeroed outside the
//            true extent [h_true, w_true), plus the prob pixel gradient
//   extrap = e on the band's own rows
//   part   = per block: sum(grad^2) per channel, sum |g|, sum |G|
//
// K1 is the whole canvas as one band (row0 = 0, no halos).  K7 is a band of
// the row-striped solve: the two rows the stencil reaches past either band
// edge come from halo arrays [C, 2, W] of f and fista (the neighbouring
// bands' rows; null: zeros, the canvas edge), not from the TPU's 8-row DMA
// tiles, and every row mask keys on the global row row0 + band row.
//
// Bound on an H100: device memory.  It moves 4 * (3C + P) bytes per pixel
// (f, fista, pgrad in; grad, extrap out) against ~150 flops per pixel.
// Design: one block of 256 threads per 16 x 32 output tile.
//   1. e is staged for all channels on the tile plus a 2-pixel halo: the
//      TGV2 gather reaches through two chained differences.  Rows past the
//      band edges come from the halo arrays.
//   2. On the tile plus a 1-pixel ring, every per-pixel term the gather
//      reads (TV: g / |g|; TGV2: the p, q, r, center terms of the 7-point
//      scatter) is computed once and kept in shared memory, instead of
//      being rebuilt by the gather for each neighbour that reads it (up
//      to six): the instructions issued, not the bytes, set the pace of
//      the version that rebuilt them (PERF.md, Findings).
//   3. Each thread gathers two output pixels from those terms, writes grad
//      and extrap once and accumulates its partial sums.
// A block writes one row of partial sums; a second kernel then reduces the
// rows in a fixed order: no float atomics, so two runs give the same bits.
// Compiled with -fmad=false, the arithmetic rounds op for op like the plain
// PyTorch version.  The edge masks follow
// jpeg2png_tpu/kernels/grad_step.py:96-138 and stripe_grad.py:188-262,
// including the pad row / column masks that apply when the true extent ends
// inside the canvas.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 32, TH = 16;          // output tile
constexpr int EW = TW + 4, EH = TH + 4;  // staged extrapolation: 2-pixel halo
constexpr int SW = TW + 2, SH = TH + 2;  // per-pixel terms: 1-pixel ring
constexpr int NT = 256;                  // threads per block
constexpr int MAXC = 4;
constexpr int HALO = 2;                  // rows of each halo array

struct Params {
  const float* f;       // [C, L, W] band
  const float* fista;
  const float* ftop;    // [C, 2, W] rows above the band, or null (zeros)
  const float* fbot;    // [C, 2, W] rows below the band, or null
  const float* fitop;
  const float* fibot;
  const float* pgrad;   // [P, L, W] or null
  float* grad;
  float* extrap;
  float* part;          // [nblocks, C + 2]
  int L, W, row0, HT, WT;
  float factor, alpha, alpha2;
  int pidx[MAXC];       // prob plane of channel c, -1 when off
};

// Tile coordinates are band rows; hl = h_true - row0 is the band row of the
// true bottom edge, top = -row0 the band row of global row 0.
template <int C>
struct Tile {
  const float* e;       // shared [C][EH][EW], origin (y0 - 2, x0 - 2)
  int y0, x0, hl, WT;

  __device__ float at(int c, int y, int x) const {
    return e[(c * EH + (y - y0 + 2)) * EW + (x - x0 + 2)];
  }
  // forward differences of the staged extrapolation (grad_step.py:96-97)
  __device__ float gx(int c, int y, int x) const {
    return x < WT - 1 ? at(c, y, x + 1) - at(c, y, x) : 0.f;
  }
  __device__ float gy(int c, int y, int x) const {
    return y < hl - 1 ? at(c, y + 1, x) - at(c, y, x) : 0.f;
  }
};

template <int N>
__device__ void block_sum(float (&v)[N], float* red, float* out) {
  // fixed-order reduction: warp tree, then warp 0 over the 8 warp sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float s = v[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) red[warp * N + j] = s;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = 0.f;
    for (int w = 0; w < NT / 32; ++w) s += red[w * N + threadIdx.x];
    out[threadIdx.x] = s;
  }
}

template <int C, bool TGV>
__global__ void __launch_bounds__(NT) grad_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int RING = SH * SW;
  float* e_s = smem;                      // [C][EH][EW]
  float* a_s = e_s + C * EH * EW;         // [C][SH][SW]  gx / |g|
  float* b_s = a_s + C * RING;            // [C][SH][SW]  gy / |g|
  float* p_s = b_s + C * RING;            // [C][SH][SW]  TGV2 gather terms:
  float* q_s = p_s + C * RING;            //   p, q, r scattered to the
  float* r_s = q_s + C * RING;            //   neighbours, c kept at home
  float* c_s = r_s + C * RING;            //   (compute.c:158-185)
  __shared__ float red[(NT / 32) * (C + 2)];

  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int tid = threadIdx.x;
  const int L = p.L, W = p.W, WT = p.WT;
  const size_t LW = (size_t)L * W;
  const int hl = p.HT - p.row0, top = -p.row0;

  // 1. extrapolation on the tile + 2-pixel halo: band rows from f / fista,
  //    the two rows past either band edge from the halo arrays, zero past
  //    the canvas.  Halo rows extrapolate with the same factor.
  for (int i = tid; i < EH * EW; i += NT) {
    const int y = y0 - 2 + i / EW, x = x0 - 2 + i % EW;
    const float* fr = nullptr;
    const float* fir = nullptr;
    size_t o = 0, plane = LW;
    if (x >= 0 && x < W) {
      if (y < 0) {
        fr = p.ftop;
        fir = p.fitop;
        o = (size_t)(HALO + y) * W + x;
        plane = (size_t)HALO * W;
      } else if (y < L) {
        fr = p.f;
        fir = p.fista;
        o = (size_t)y * W + x;
      } else if (y < L + HALO) {
        fr = p.fbot;
        fir = p.fibot;
        o = (size_t)(y - L) * W + x;
        plane = (size_t)HALO * W;
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float v = 0.f;
      if (fr != nullptr) {
        const float fv = fr[c * plane + o];
        v = fv + p.factor * (fv - fir[c * plane + o]);
      }
      e_s[c * EH * EW + i] = v;
    }
  }
  __syncthreads();
  const Tile<C> t{e_s, y0, x0, hl, WT};

  // 2. per-pixel terms on the tile + 1-pixel ring, each computed once:
  //    the normalized TV differences and the TGV2 gather terms
  float acc[C + 2];
#pragma unroll
  for (int j = 0; j < C + 2; ++j) acc[j] = 0.f;
  for (int i = tid; i < RING; i += NT) {
    const int r = i / SW, q = i % SW;
    const int y = y0 - 1 + r, x = x0 - 1 + q;
    const bool own = r >= 1 && r <= TH && q >= 1 && q <= TW && y < L && x < W;
    float gx[C], gy[C];
    float gsq = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      gx[c] = t.gx(c, y, x);
      gy[c] = t.gy(c, y, x);
      const float term = gx[c] * gx[c] + gy[c] * gy[c];
      gsq = c == 0 ? term : gsq + term;
    }
    const float gn = sqrtf(gsq);
    const float inv = gn == 0.f ? 0.f : 1.f / gn;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      a_s[c * RING + i] = gx[c] * inv;
      b_s[c * RING + i] = gy[c] * inv;
    }
    if (own) acc[C] += gn;
    if (TGV) {
      const bool yin = y >= top + 1 && y < hl;   // global row in [1, h_true)
      float g_xx[C], sym[C], g_yy[C];
      float n2sq = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        g_xx[c] = x >= 1 ? gx[c] - t.gx(c, y, x - 1) : 0.f;
        const float g_yx = (x >= 1 && x < WT) ? gy[c] - t.gy(c, y, x - 1) : 0.f;
        const float g_xy = yin ? gx[c] - t.gx(c, y - 1, x) : 0.f;
        g_yy[c] = yin ? gy[c] - t.gy(c, y - 1, x) : 0.f;
        sym[c] = (g_xy + g_yx) * 0.5f;
        const float term = g_xx[c] * g_xx[c] + 2.f * sym[c] * sym[c]
                           + g_yy[c] * g_yy[c];
        n2sq = c == 0 ? term : n2sq + term;
      }
      const float n2 = sqrtf(n2sq);
      const float inv2 = n2 == 0.f ? 0.f : 1.f / n2;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        c_s[c * RING + i] = -(2.f * g_xx[c] + 2.f * sym[c] + 2.f * g_yy[c]) * inv2;
        p_s[c * RING + i] = (g_xx[c] + sym[c]) * inv2;
        q_s[c * RING + i] = (g_yy[c] + sym[c]) * inv2;
        r_s[c * RING + i] = -sym[c] * inv2;
      }
      if (own) acc[C + 1] += n2;
    }
  }
  __syncthreads();

  // 3. gather: two output pixels per thread
  const int tx = tid % TW, ty = tid / TW;
#pragma unroll
  for (int k = 0; k < TH / (NT / TW); ++k) {
    const int ly = ty + k * (NT / TW);
    const int y = y0 + ly, x = x0 + tx;
    if (y >= L || x >= W) continue;
    const int s = (ly + 1) * SW + (tx + 1);   // ring index of (y, x)
    const bool in_true = y < hl && x < WT;
    const bool up = y >= top + 1 && y - 1 < hl, down = y + 1 < hl;
    const bool left = x >= 1, right = x + 1 < W;
    const size_t o = (size_t)y * W + x;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = c * RING + s;
      // TV: self -(a+b), from the left +a, from above +b (compute.c:98-104)
      const float a_l = left ? a_s[j - 1] : 0.f;
      const float b_u = up ? b_s[j - SW] : 0.f;
      float g = (-(a_s[j] + b_s[j]) + a_l + b_u) * p.alpha;
      if (TGV) {
        float g2 = c_s[j];
        g2 = g2 + (right ? p_s[j + 1] : 0.f);
        g2 = g2 + (left ? p_s[j - 1] : 0.f);
        g2 = g2 + (down ? q_s[j + SW] : 0.f);
        g2 = g2 + (up ? q_s[j - SW] : 0.f);
        g2 = g2 + ((left && down) ? r_s[j + SW - 1] : 0.f);
        g2 = g2 + ((right && up) ? r_s[j - SW + 1] : 0.f);
        g = g + p.alpha2 * g2;
      }
      if (!in_true) g = 0.f;   // padding stays frozen (grad_step.py:286-293)
      if (p.pidx[c] >= 0) g = g + p.pgrad[p.pidx[c] * LW + o];
      p.grad[c * LW + o] = g;
      p.extrap[c * LW + o] = t.at(c, y, x);
      acc[c] += g * g;
    }
  }
  __syncthreads();
  block_sum<C + 2>(acc, red,
                   p.part + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * (C + 2));
}

// out[j] = scale[j] * sum_b part[b, j], one block per column, fixed order.
__global__ void __launch_bounds__(NT)
reduce_columns(const float* part, int nrows, int ncols, float* out,
               float scale_tv, float scale_tv2, int C) {
  __shared__ float red[NT];
  const int j = blockIdx.x;
  float s = 0.f;
  for (int b = threadIdx.x; b < nrows; b += NT) s += part[(size_t)b * ncols + j];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = NT / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float scale = j == C ? scale_tv : (j == C + 1 ? scale_tv2 : 1.f);
    out[j] = scale * red[0];
  }
}

template <int C, bool TGV>
cudaError_t launch(const Params& p, dim3 grid, cudaStream_t stream) {
  constexpr size_t bytes =
      (C * EH * EW + (TGV ? 6 : 2) * C * SH * SW) * sizeof(float);
  static_assert(bytes <= 227 * 1024, "tile exceeds a block's shared memory");
  if (bytes > 48 * 1024) {
    // above 48 KB only after the opt-in (70 KB at C = 4 with TGV2)
    const cudaError_t err = cudaFuncSetAttribute(
        grad_kernel<C, TGV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
  }
  grad_kernel<C, TGV><<<grid, NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

// Launches the gradient kernel and the fixed-order reduction of its
// partial sums; returns the first CUDA error, else 0.
int run(const Params& p, int C, int tgv, float* out, cudaStream_t s) {
  if (C < 1 || C > MAXC || p.L < 1 || p.W < 1) return (int)cudaErrorInvalidValue;
  // a null halo pair reads as zeros: f and fista halos go together
  if ((p.ftop == nullptr) != (p.fitop == nullptr) ||
      (p.fbot == nullptr) != (p.fibot == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((p.W + TW - 1) / TW, (p.L + TH - 1) / TH);
  cudaError_t err;
  switch (C * 2 + (tgv ? 1 : 0)) {
    case 2: err = launch<1, false>(p, grid, s); break;
    case 3: err = launch<1, true>(p, grid, s); break;
    case 4: err = launch<2, false>(p, grid, s); break;
    case 5: err = launch<2, true>(p, grid, s); break;
    case 6: err = launch<3, false>(p, grid, s); break;
    case 7: err = launch<3, true>(p, grid, s); break;
    case 8: err = launch<4, false>(p, grid, s); break;
    default: err = launch<4, true>(p, grid, s); break;
  }
  if (err != cudaSuccess) return (int)err;
  reduce_columns<<<C + 2, NT, 0, s>>>(p.part, (int)(grid.x * grid.y), C + 2,
                                      out, p.alpha, tgv ? p.alpha2 : 0.f, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* j2p_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// A band of L rows of a [C, h_pad, W] canvas, its first row global row
// row0 (K1: the whole canvas, row0 = 0, null halos); f, fista, pgrad
// ([P, L, W]), grad, extrap: band tensors; ftop / fbot and fitop / fibot:
// [C, 2, W] halo rows of f and fista just above / below the band, null for
// zeros (the canvas edge).  part: [ceil(L/16) * ceil(W/32), C + 2] scratch;
// out: [C + 2] = the band's (sum grad^2 per channel, tv, tv2).  alpha =
// 1/sqrt(C) and alpha2 = (weight/sqrt(2))/sqrt(C) come from the caller,
// rounded once to f32 as the plain version rounds them; tgv = 0 skips the
// second-order term.  Returns the first CUDA error, else 0.
int j2p_fused_grad_striped(const float* f, const float* fista,
                           const float* ftop, const float* fbot,
                           const float* fitop, const float* fibot,
                           const float* pgrad, float* grad, float* extrap,
                           float* part, float* out, int C, int L, int W,
                           int row0, int h_true, int w_true, float factor,
                           float alpha, float alpha2, int tgv, int pidx0,
                           int pidx1, int pidx2, int pidx3, void* stream) {
  Params p;
  p.f = f;
  p.fista = fista;
  p.ftop = ftop;
  p.fbot = fbot;
  p.fitop = fitop;
  p.fibot = fibot;
  p.pgrad = pgrad;
  p.grad = grad;
  p.extrap = extrap;
  p.part = part;
  p.L = L;
  p.W = W;
  p.row0 = row0;
  p.HT = h_true;
  p.WT = w_true;
  p.factor = factor;
  p.alpha = alpha;
  p.alpha2 = alpha2;
  p.pidx[0] = pidx0;
  p.pidx[1] = pidx1;
  p.pidx[2] = pidx2;
  p.pidx[3] = pidx3;
  return run(p, C, tgv, out, (cudaStream_t)stream);
}

}  // extern "C"
