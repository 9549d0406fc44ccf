// K4: the lite band gradient (bf16 FISTA difference in, bf16 gradient out),
// for Hopper.
//
// Replaces the Pallas kernel
// jpeg2png_tpu/kernels/stripe_grad.py::fused_grad_striped_lite (_kernel_lite).
// For a band of L rows of a [C, L, W] canvas whose first row is global row
// row0 (reference: compute.c:38-70, 73-197, 427-440):
//
//   e     = f + factor * d              (f f32, d = f - fista in bf16)
//   grad  = alpha * TV gather + alpha2 * TGV2 gather of e, zeroed outside
//           the true extent [h_true, w_true), + p_alpha * up(idct(devq))
//   out   grad in bf16 (round to nearest even)
//   part  = per block: sum(grad^2) per channel of the f32 gradient,
//           sum |g|, sum |G|
//
// The two rows past either band edge come from halo arrays [C, 2, W]
// (null: zeros).  The edge masks key on the global row row0 + y and on the
// true extent, static or read from a [2] device array (dynamic extents).
//
// Bound on an H100: device memory: 10 B per pixel and channel (f, d in;
// grad out) plus 2 B per prob coefficient, against ~150 flops per pixel.
// Design: K1's tile (csrc/grad_step.cu): one block of 256 threads per
// 16 x 32 output tile stages e for all channels with a 2-pixel halo and
// computes every per-pixel term of the gather once on the tile plus a
// 1-pixel ring in shared memory; the prob gradient is K3's
// (csrc/iter_step.cu): the devq blocks under the tile are staged and
// transformed in shared memory.  A block writes one row of partial sums;
// a second kernel reduces the rows in a fixed order (no float atomics).
// Built with -fmad=false like K1: the stencil rounds op for op like the
// plain PyTorch version, so the bf16 outputs agree away from rounding ties.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 32, TH = 16;          // output tile
constexpr int EW = TW + 4, EH = TH + 4;  // staged extrapolation: 2-pixel halo
constexpr int SW = TW + 2, SH = TH + 2;  // per-pixel terms: 1-pixel ring
constexpr int XS = TW + 1;               // row stride of a prob window
constexpr int XN = TH * XS;              // floats of one prob window
constexpr int NT = 256;
constexpr int MAXC = 4;
constexpr int HALO = 2;                  // rows of each halo array

__constant__ float c_D[64] = {
    0.35355338454246521f, 0.35355338454246521f, 0.35355338454246521f, 0.35355338454246521f,
    0.35355338454246521f, 0.35355338454246521f, 0.35355338454246521f, 0.35355338454246521f,
    0.49039262533187866f, 0.41573479771614075f, 0.27778512239456177f, 0.097545161843299866f,
    -0.097545161843299866f, -0.27778512239456177f, -0.41573479771614075f, -0.49039262533187866f,
    0.46193975210189819f, 0.19134171307086945f, -0.19134171307086945f, -0.46193975210189819f,
    -0.46193975210189819f, -0.19134171307086945f, 0.19134171307086945f, 0.46193975210189819f,
    0.41573479771614075f, -0.097545161843299866f, -0.49039262533187866f, -0.27778512239456177f,
    0.27778512239456177f, 0.49039262533187866f, 0.097545161843299866f, -0.41573479771614075f,
    0.35355338454246521f, -0.35355338454246521f, -0.35355338454246521f, 0.35355338454246521f,
    0.35355338454246521f, -0.35355338454246521f, -0.35355338454246521f, 0.35355338454246521f,
    0.27778512239456177f, -0.49039262533187866f, 0.097545161843299866f, 0.41573479771614075f,
    -0.41573479771614075f, -0.097545161843299866f, 0.49039262533187866f, -0.27778512239456177f,
    0.19134171307086945f, -0.46193975210189819f, 0.46193975210189819f, -0.19134171307086945f,
    -0.19134171307086945f, 0.46193975210189819f, -0.46193975210189819f, 0.19134171307086945f,
    0.097545161843299866f, -0.27778512239456177f, 0.41573479771614075f, -0.49039262533187866f,
    0.49039262533187866f, -0.41573479771614075f, 0.27778512239456177f, -0.097545161843299866f,
};

__device__ __forceinline__ float bf2f(uint16_t b) {
  return __uint_as_float((uint32_t)b << 16);
}
__device__ __forceinline__ uint16_t f2bf(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

struct Params {
  const float* f;          // [C, L, W]
  const uint16_t* d;       // [C, L, W] bf16
  const float* ftop;       // [C, 2, W] or null (zeros)
  const float* fbot;
  const uint16_t* dtop;    // [C, 2, W] bf16 or null
  const uint16_t* dbot;
  uint16_t* grad;          // [C, L, W] bf16 out
  float* part;             // [nblocks, C + 2]
  const int* ext;          // [2] true (h, w), or null: HT, WT below
  int L, W, row0, HT, WT;
  float factor, alpha, alpha2;
  const uint16_t* devq[MAXC];  // [L/sy, W/sx] bf16, null when prob is off
  float pa[MAXC];
  int sy[MAXC], sx[MAXC], pidx[MAXC];
};

template <int C, bool TGV>
struct Smem {
  static constexpr int RING = SH * SW;
  static constexpr int E = C * EH * EW;
  static constexpr int TERMS = (TGV ? 6 : 2) * C * RING;
  // prob windows: staging + intermediate, then one per prob channel
  static constexpr int FLOATS = E + TERMS + (2 + C) * XN;
};

template <int N>
__device__ void block_sum(float (&v)[N], float* red, float* out) {
  // fixed-order reduction: warp tree, then the 8 warp sums in order
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
__global__ void __launch_bounds__(NT) grad_lite_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int RING = Smem<C, TGV>::RING;
  float* e_s = smem;                      // [C][EH][EW]
  float* a_s = e_s + C * EH * EW;         // [C][SH][SW] gx / |g|
  float* b_s = a_s + C * RING;            // [C][SH][SW] gy / |g|
  float* p_s = b_s + C * RING;            // TGV2 gather terms
  float* q_s = p_s + C * RING;
  float* r_s = q_s + C * RING;
  float* c_s = r_s + C * RING;
  float* x_s = e_s + Smem<C, TGV>::E + Smem<C, TGV>::TERMS;   // [TH][XS]
  float* t_s = x_s + XN;                                      // [TH][XS]
  float* pg_s = t_s + XN;                                     // [P][TH][XS]
  __shared__ float Ds[64];
  __shared__ float red[(NT / 32) * (C + 2)];

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int L = p.L, W = p.W;
  const size_t LW = (size_t)L * W;
  const int HT = p.ext ? p.ext[0] : p.HT;
  const int WT = p.ext ? p.ext[1] : p.WT;
  // the masks in band rows: hl = local row of the true bottom edge,
  // top = local row of global row 0
  const int hl = HT - p.row0, top = -p.row0;
  if (tid < 64) Ds[tid] = c_D[tid];

  // 1. e on the tile + 2-pixel halo: band rows from f / d, the two rows
  //    past either band edge from the halo arrays, zero past the canvas
  for (int i = tid; i < EH * EW; i += NT) {
    const int y = y0 - 2 + i / EW, x = x0 - 2 + i % EW;
    const float* fr = nullptr;
    const uint16_t* dr = nullptr;
    size_t o = 0;
    if (x >= 0 && x < W) {
      if (y < 0) {
        fr = p.ftop;
        dr = p.dtop;
        o = (size_t)(HALO + y) * W + x;
      } else if (y < L) {
        fr = p.f;
        dr = p.d;
        o = (size_t)y * W + x;
      } else if (y < L + HALO) {
        fr = p.fbot;
        dr = p.dbot;
        o = (size_t)(y - L) * W + x;
      }
    }
    const size_t plane = fr == p.f ? LW : (size_t)HALO * W;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float v = 0.f;
      if (fr != nullptr) v = fr[c * plane + o] + p.factor * bf2f(dr[c * plane + o]);
      e_s[c * EH * EW + i] = v;
    }
  }
  __syncthreads();

  // 2. prob gradient windows: idct of the devq blocks under the tile, at
  //    coefficient resolution (expanded over the footprint at the gather)
  int wy0[C], wx0[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int sy = p.sy[c], sx = p.sx[c];
    wy0[c] = (y0 / (8 * sy)) * 8;
    wx0[c] = (x0 / (8 * sx)) * 8;
    if (p.pidx[c] < 0) continue;
    const int hc = L / sy, wc = W / sx;
    const int rows = min((y0 + TH - 1) / sy + 1, hc) - wy0[c];
    const int r8 = (rows + 7) / 8 * 8;
    const int cols = min((x0 + TW - 1) / sx + 1, wc) - wx0[c];
    const int c8 = (cols + 7) / 8 * 8;
    const uint16_t* dv = p.devq[c];
    for (int i = tid; i < r8 * c8; i += NT) {
      const int r = i / c8, k = i % c8;
      x_s[r * XS + k] = bf2f(dv[(size_t)(wy0[c] + r) * wc + wx0[c] + k]);
    }
    __syncthreads();
    // rows: T[u][j] = sum_v X[u][v] D[v][j] within each 8x8 block
    for (int i = tid; i < r8 * c8; i += NT) {
      const int r = i / c8, k = i % c8, k0 = k & ~7, j = k & 7;
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < 8; ++v) s += x_s[r * XS + k0 + v] * Ds[v * 8 + j];
      t_s[r * XS + k] = s;
    }
    __syncthreads();
    // columns: out[i][j] = sum_u D[u][i] T[u][j]
    float* out = pg_s + p.pidx[c] * XN;
    for (int i = tid; i < r8 * c8; i += NT) {
      const int r = i / c8, k = i % c8, r0 = r & ~7, ii = r & 7;
      float s = 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) s += Ds[u * 8 + ii] * t_s[(r0 + u) * XS + k];
      out[r * XS + k] = s;
    }
    __syncthreads();
  }

  // 3. per-pixel terms on the tile + 1-pixel ring (K1's step 2), with the
  //    row masks in band coordinates
  auto at = [&](int c, int y, int x) {
    return e_s[(c * EH + (y - y0 + 2)) * EW + (x - x0 + 2)];
  };
  auto gxf = [&](int c, int y, int x) {
    return x < WT - 1 ? at(c, y, x + 1) - at(c, y, x) : 0.f;
  };
  auto gyf = [&](int c, int y, int x) {
    return y < hl - 1 ? at(c, y + 1, x) - at(c, y, x) : 0.f;
  };
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
      gx[c] = gxf(c, y, x);
      gy[c] = gyf(c, y, x);
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
      const bool yin = y >= top + 1 && y < hl;
      float g_xx[C], sym[C], g_yy[C];
      float n2sq = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        g_xx[c] = x >= 1 ? gx[c] - gxf(c, y, x - 1) : 0.f;
        const float g_yx = (x >= 1 && x < WT) ? gy[c] - gyf(c, y, x - 1) : 0.f;
        const float g_xy = yin ? gx[c] - gxf(c, y - 1, x) : 0.f;
        g_yy[c] = yin ? gy[c] - gyf(c, y - 1, x) : 0.f;
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

  // 4. gather: two output pixels per thread
  const int tx = tid % TW, ty = tid / TW;
#pragma unroll
  for (int k = 0; k < TH / (NT / TW); ++k) {
    const int ly = ty + k * (NT / TW);
    const int y = y0 + ly, x = x0 + tx;
    if (y >= L || x >= W) continue;
    const int s = (ly + 1) * SW + (tx + 1);
    const bool in_true = y < hl && x < WT;
    const bool up = y >= top + 1 && y - 1 < hl, down = y + 1 < hl;
    const bool left = x >= 1, right = x + 1 < W;
    const size_t o = (size_t)y * W + x;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = c * RING + s;
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
      if (!in_true) g = 0.f;   // padding stays frozen (stripe_grad.py:573-587)
      if (p.pidx[c] >= 0) {
        const float v = pg_s[p.pidx[c] * XN + (y / p.sy[c] - wy0[c]) * XS
                             + (x / p.sx[c] - wx0[c])];
        g = g + p.pa[c] * v;
      }
      p.grad[c * LW + o] = f2bf(g);
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
  constexpr size_t bytes = Smem<C, TGV>::FLOATS * sizeof(float);
  static_assert(bytes <= 200 * 1024, "tile exceeds a block's shared memory");
  const cudaError_t err = cudaFuncSetAttribute(
      grad_lite_kernel<C, TGV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  grad_lite_kernel<C, TGV><<<grid, NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const Params&, dim3, cudaStream_t);
// index (C - 1) * 2 + tgv
const LaunchFn kLaunch[2 * MAXC] = {
    launch<1, false>, launch<1, true>, launch<2, false>, launch<2, true>,
    launch<3, false>, launch<3, true>, launch<4, false>, launch<4, true>};

}  // namespace

extern "C" {

const char* j2p_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// f: [C, L, W] f32; d, grad: [C, L, W] bf16; ftop/fbot [C, 2, W] f32 and
// dtop/dbot [C, 2, W] bf16 or null (zeros); part: [ceil(L/16) * ceil(W/32),
// C + 2] scratch; out: [C + 2] = (sum grad^2 per channel, tv, tv2); ext: [2]
// int32 true (h, w) on the device, or null for h_true / w_true.
// devq[c]: [L/sy, W/sx] bf16 plane of channel c, 0 when its prob term is
// off; ints[2c..2c+1]: sy, sx; pa[c]: p_alpha.  alpha = 1/sqrt(C) and
// alpha2 = (weight/sqrt(2))/sqrt(C) come rounded from the caller; tgv = 0
// skips the second-order term.  Returns the first CUDA error, else 0.
int j2p_fused_grad_lite(const float* f, const uint16_t* d, const float* ftop,
                        const float* fbot, const uint16_t* dtop,
                        const uint16_t* dbot, uint16_t* grad, float* part,
                        float* out, const int* ext, const uint64_t* devq,
                        const int* ints, const float* pa, int C, int L, int W,
                        int row0, int h_true, int w_true, float factor,
                        float alpha, float alpha2, int tgv, void* stream) {
  if (C < 1 || C > MAXC || L < 1 || W < 1) return (int)cudaErrorInvalidValue;
  Params p;
  p.f = f;
  p.d = d;
  p.ftop = ftop;
  p.fbot = fbot;
  p.dtop = dtop;
  p.dbot = dbot;
  p.grad = grad;
  p.part = part;
  p.ext = ext;
  p.L = L;
  p.W = W;
  p.row0 = row0;
  p.HT = h_true;
  p.WT = w_true;
  p.factor = factor;
  p.alpha = alpha;
  p.alpha2 = alpha2;
  // a null halo pair reads as zeros: f and d halos go together
  if ((ftop == nullptr) != (dtop == nullptr) || (fbot == nullptr) != (dbot == nullptr))
    return (int)cudaErrorInvalidValue;
  int P = 0;
  for (int c = 0; c < C; ++c) {
    p.sy[c] = ints[2 * c];
    p.sx[c] = ints[2 * c + 1];
    // footprints 1, 2 or 4 per axis (a 16 x 32 tile then covers whole
    // or half coefficient blocks), the band whole 8x8 blocks
    if ((p.sy[c] != 1 && p.sy[c] != 2 && p.sy[c] != 4) ||
        (p.sx[c] != 1 && p.sx[c] != 2 && p.sx[c] != 4) ||
        L % (8 * p.sy[c]) || W % (8 * p.sx[c]))
      return (int)cudaErrorInvalidValue;
    p.devq[c] = (const uint16_t*)devq[c];
    p.pa[c] = pa[c];
    p.pidx[c] = devq[c] ? P++ : -1;
  }
  const dim3 grid((W + TW - 1) / TW, (L + TH - 1) / TH);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = kLaunch[(C - 1) * 2 + (tgv ? 1 : 0)](p, grid, s);
  if (err != cudaSuccess) return (int)err;
  reduce_columns<<<C + 2, NT, 0, s>>>(part, (int)(grid.x * grid.y), C + 2, out,
                                      alpha, tgv ? alpha2 : 0.f, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
