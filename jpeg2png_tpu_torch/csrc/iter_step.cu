// K3: the whole solve (all iterations of a chunk) in one launch, for Hopper.
//
// Replaces the Pallas kernel jpeg2png_tpu/kernels/iter_step.py::fused_solve
// (_kernel).  For B images padded into one [H, W] bucket canvas with C
// channels, runs nsteps iterations of the port's two-kernel body (K1
// csrc/grad_step.cu + K2 csrc/project_step.cu; reference compute.c:406-465):
//
//   gradient phase, per 16 x 32 tile of every image:
//     e     = f + factor * (f - fista)
//     grad  = alpha * TV gather + alpha2 * TGV2 gather of e, zeroed outside
//             the image's true extent, + p_alpha * up(idct(devq))
//   grid barrier; every block reduces sumsq per image and channel in one
//   fixed order and takes scale = step / sqrt(sumsq) (0 at zero norm)
//   projection phase, per (image, channel, 4 coefficient blocks):
//     fmid  = e - scale * grad           (e recomputed from f and fista)
//     clamp = clip(D mean(fmid) D^T, lo, hi), lo/hi from data * q -+ q / 2
//     fnew  = (fmid - up(mean)) + up(D^T clamp D)
//     devp  = (clamp - dq) * iq, devq = devp * iq, dist += devp^2
//     fista = f, f = fnew                (the FISTA swap, in place)
//   grid barrier
//
// q == 0 marks frozen canvas padding (box [0, 0], iq = 0) and q >= 2^39
// a region gap (unconstrained box, iq = 0): project_step.py:658-664.
// The prob gradient is carried at coefficient resolution (devq) and
// expanded per tile from the 8x8 blocks under it, as the TPU kernel does.
//
// Bound on an H100: device memory.  Per iteration and pixel-channel it
// reads f and fista and writes grad (gradient phase; the halos come from
// the caches), then reads f, fista and grad and writes f and fista: 32 B,
// plus 10 B per coefficient (int16 data, f32 q, devq read and written).
// A bucket whose whole state fits in the 50 MB L2 can run below that
// device-memory bound.
// Design: one persistent cooperative launch whose grid is exactly the
// co-resident blocks (occupancy x SMs).  Blocks walk (image, tile) and
// (image, channel, block row, 4 blocks) work items in a fixed strided
// order; the TPU kernel's sequential (nsteps, 2 NS) grid becomes a loop
// with two grid barriers per iteration, reached by every block whether or
// not it had work.  The gradient tile is K1's (the gather terms computed
// once per pixel in shared memory), the projection item is K2's (one
// thread per coefficient, transforms in shared memory).  Partial sums go
// through per-block rows reduced in a fixed order: no float atomics, so
// two runs give the same bits.  Buffers written inside the launch are read
// with ld.global.cg (L2, not the SM's non-coherent L1).  Built with
// -fmad=false like K1, so the stencil rounds op for op like the plain
// PyTorch version.  Removing the per-iteration launches and host work is
// what this kernel buys; keeping a bucket's state resident in L2 or
// shared memory is later work.
//
// Lite mode (LITE = true; the TPU kernel's lite=True, iter_step.py:664-670,
// 696-704, 758-761): the side buffers hold bf16 in place of f32 — the FISTA
// shadow becomes the difference d = f - fista (e = f + factor * d), the
// gradient and devq are rounded to bf16 where they are stored (sumsq from
// the f32 gradient), and the swap writes d = bf16(fnew - f).  One template
// on the side buffers' storage type; the arithmetic is otherwise the f32
// mode's, so an iteration equals K4 (csrc/stripe_grad.cu) then K5
// (csrc/project_lite.cu).  Per iteration and pixel-channel it moves 22 B
// instead of 32 B.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TW = 32, TH = 16;          // gradient tile
constexpr int EW = TW + 4, EH = TH + 4;  // staged extrapolation: 2-pixel halo
constexpr int SW = TW + 2, SH = TH + 2;  // per-pixel gather terms: 1-pixel ring
constexpr int XS = TW + 1;               // row stride of a prob window
constexpr int XN = TH * XS;              // floats of one prob window
constexpr int NT = 256;
constexpr int MAXC = 4, MAXB = 8, NCOL = 8;
constexpr int KB = 4;                    // coefficient blocks per projection item

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

struct Chan {
  const int16_t* data;  // [B, hc, wc] quantized coefficients (read only)
  const float* q;       // [B, hc, wc] quant raster (read only)
  void* devq;           // [B, hc, wc] prob carry (f32, lite: bf16), or null
  float pa;             // p_alpha
  int pidx;             // prob column / window index, -1 when off
  int sy, sx, hc, wc;
  int nbx4;             // projection items per coefficient block row
  int item0;            // first projection item of this channel in an image
};

struct Params {
  float* f;             // [B, C, H, W] iterate, updated in place
  void* fista;          // [B, C, H, W] FISTA shadow (lite: bf16 d = f - fista)
  void* grad;           // [B, C, H, W] scratch (lite: bf16)
  const float* factors; // [nsteps]
  const int* ext;       // [B, 2] true (h, w)
  const float* steps;   // [B] step size
  float* out;           // [B, nsteps, NCOL] partials rows
  float* gpart;         // [G, B, C + 2] per-block gradient sums
  float* dpart;         // [G, B, max(P, 1)] per-block distance sums
  int B, C, H, W, nsteps, P;
  int tiles_x, tiles_img, items_img;
  float alpha, alpha2;
  Chan ch[MAXC];
};

__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }

// element i of a side buffer (f32, or bf16 in lite mode), through L2
template <bool LITE>
__device__ __forceinline__ float side_ld(const void* base, size_t i) {
  if constexpr (LITE)
    return __uint_as_float((uint32_t)__ldcg((const unsigned short*)base + i) << 16);
  else
    return __ldcg((const float*)base + i);
}

// store v to element i of a side buffer (bf16: round to nearest even)
template <bool LITE>
__device__ __forceinline__ void side_st(void* base, size_t i, float v) {
  if constexpr (LITE)
    ((uint16_t*)base)[i] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  else
    ((float*)base)[i] = v;
}

// fixed-order block sum of v (per thread) -> returned on thread 0
__device__ float block_total(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < NT / 32; ++w) t += red[w];
  __syncthreads();
  return t;
}

// out[j] = fixed-order block sum of v[j], j < N (thread 0 writes)
template <int N>
__device__ void flush(const float (&v)[N], float* red, float* out) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float t = block_total(v[j], red);
    if (threadIdx.x == 0) out[j] = t;
  }
}

// sum over the G rows of column `col` of a [G, stride] buffer, by one
// warp, in one fixed order (lane-strided, then a shuffle tree) -> lane 0
__device__ float warp_column_sum(const float* buf, int G, int stride, int col) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int g = lane; g < G; g += 32) s += ldcg(buf + (size_t)g * stride + col);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  return s;
}

// block 0: out[b, it, C + 2 + p] = 0.5 * sum of the distance partials
__device__ void write_dists(const Params& p, int it) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Pd = p.P > 0 ? p.P : 1;
  for (int k = warp; k < p.B * p.P; k += NT / 32) {
    const int b = k / p.P, j = k % p.P;
    const float s = warp_column_sum(p.dpart, gridDim.x, p.B * Pd, b * Pd + j);
    if (lane == 0)
      p.out[((size_t)b * p.nsteps + it) * NCOL + p.C + 2 + j] = 0.5f * s;
  }
}

template <int C, bool TGV>
struct Smem {
  static constexpr int RING = SH * SW;
  static constexpr int E = C * EH * EW;
  static constexpr int TERMS = (TGV ? 6 : 2) * C * RING;
  // windows: staging + intermediate, then one per prob channel (P <= C)
  static constexpr int GRAD = E + TERMS + (2 + C) * XN;
  static constexpr int PROJ = 2 * KB * 8 * 9;
  static constexpr int FLOATS = GRAD > PROJ ? GRAD : PROJ;
};

// ---------------------------------------------------------------- gradient

template <int C, bool TGV, bool LITE>
__device__ __forceinline__ void grad_tile(const Params& p, float* smem,
                                          const float* Ds, int b, int tile,
                                          float factor, float (&acc)[C + 2]) {
  constexpr int RING = Smem<C, TGV>::RING;
  float* e_s = smem;                                   // [C][EH][EW]
  float* a_s = e_s + C * EH * EW;                      // [C][SH][SW] gx / |g|
  float* b_s = a_s + C * RING;                         // [C][SH][SW] gy / |g|
  float* p_s = b_s + C * RING;                         // TGV2 gather terms
  float* q_s = p_s + C * RING;
  float* r_s = q_s + C * RING;
  float* c_s = r_s + C * RING;
  float* x_s = e_s + Smem<C, TGV>::E + Smem<C, TGV>::TERMS;   // [TH][XS]
  float* t_s = x_s + XN;                                      // [TH][XS]
  float* pg_s = t_s + XN;                                     // [P][TH][XS]

  const int tid = threadIdx.x;
  const int y0 = (tile / p.tiles_x) * TH, x0 = (tile % p.tiles_x) * TW;
  const int H = p.H, W = p.W;
  const int HT = p.ext[2 * b], WT = p.ext[2 * b + 1];
  const size_t HW = (size_t)H * W;
  const float* f = p.f + (size_t)b * C * HW;
  const size_t side0 = (size_t)b * C * HW;   // this image in the side buffers

  __syncthreads();   // the previous item is done with shared memory

  // 1. extrapolation on the tile + 2-pixel halo, zero outside the canvas
  for (int i = tid; i < EH * EW; i += NT) {
    const int y = y0 - 2 + i / EW, x = x0 - 2 + i % EW;
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    const size_t o = (size_t)y * W + x;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float v = 0.f;
      if (in) {
        const float fv = ldcg(f + c * HW + o);
        if constexpr (LITE)
          v = fv + factor * side_ld<true>(p.fista, side0 + c * HW + o);
        else
          v = fv + factor * (fv - side_ld<false>(p.fista, side0 + c * HW + o));
      }
      e_s[c * EH * EW + i] = v;
    }
  }

  // 2. prob gradient windows: idct of the devq blocks under the tile, at
  //    coefficient resolution (expanded over the footprint at the gather)
  int wy0[C], wx0[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const Chan& ch = p.ch[c];
    wy0[c] = (y0 / (8 * ch.sy)) * 8;
    wx0[c] = (x0 / (8 * ch.sx)) * 8;
    if (ch.pidx < 0) continue;
    const int rows = min((y0 + TH - 1) / ch.sy + 1, ch.hc) - wy0[c];
    const int r8 = (rows + 7) / 8 * 8;
    const int cols = min((x0 + TW - 1) / ch.sx + 1, ch.wc) - wx0[c];
    const int c8 = (cols + 7) / 8 * 8;
    const size_t dv = (size_t)b * ch.hc * ch.wc;
    for (int i = tid; i < r8 * c8; i += NT) {
      const int r = i / c8, k = i % c8;
      x_s[r * XS + k] = side_ld<LITE>(
          ch.devq, dv + (size_t)(wy0[c] + r) * ch.wc + wx0[c] + k);
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
    float* out = pg_s + ch.pidx * XN;
    for (int i = tid; i < r8 * c8; i += NT) {
      const int r = i / c8, k = i % c8, r0 = r & ~7, ii = r & 7;
      float s = 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) s += Ds[u * 8 + ii] * t_s[(r0 + u) * XS + k];
      out[r * XS + k] = s;
    }
    __syncthreads();
  }
  __syncthreads();

  // 3. per-pixel terms on the tile + 1-pixel ring (K1's step 2)
  auto at = [&](int c, int y, int x) {
    return e_s[(c * EH + (y - y0 + 2)) * EW + (x - x0 + 2)];
  };
  auto gxf = [&](int c, int y, int x) {
    return x < WT - 1 ? at(c, y, x + 1) - at(c, y, x) : 0.f;
  };
  auto gyf = [&](int c, int y, int x) {
    return y < HT - 1 ? at(c, y + 1, x) - at(c, y, x) : 0.f;
  };
  for (int i = tid; i < RING; i += NT) {
    const int r = i / SW, q = i % SW;
    const int y = y0 - 1 + r, x = x0 - 1 + q;
    const bool own = r >= 1 && r <= TH && q >= 1 && q <= TW && y < H && x < W;
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
      float g_xx[C], sym[C], g_yy[C];
      float n2sq = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        g_xx[c] = x >= 1 ? gx[c] - gxf(c, y, x - 1) : 0.f;
        const float g_yx = (x >= 1 && x < WT) ? gy[c] - gyf(c, y, x - 1) : 0.f;
        const float g_xy = (y >= 1 && y < HT) ? gx[c] - gxf(c, y - 1, x) : 0.f;
        g_yy[c] = (y >= 1 && y < HT) ? gy[c] - gyf(c, y - 1, x) : 0.f;
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
    if (y >= H || x >= W) continue;
    const int s = (ly + 1) * SW + (tx + 1);
    const bool in_true = y < HT && x < WT;
    const bool up = y >= 1 && y - 1 < HT, down = y + 1 < HT;
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
      if (!in_true) g = 0.f;   // padding stays frozen (iter_step.py:319-335)
      const Chan& ch = p.ch[c];
      if (ch.pidx >= 0) {
        const float v = pg_s[ch.pidx * XN + (y / ch.sy - wy0[c]) * XS
                             + (x / ch.sx - wx0[c])];
        g = g + ch.pa * v;
      }
      side_st<LITE>(p.grad, side0 + c * HW + o, g);
      acc[c] += g * g;   // the f32 value, also in lite mode
    }
  }
}

// ---------------------------------------------------------------- projection

// returns this thread's distance term; *key = b * NCOL + prob column of
// the item's channel, or -1 when its prob term is off
template <bool LITE>
__device__ __forceinline__ float project_item(const Params& p, float* smem,
                                              const float* Ds,
                                              const float* scale_s, int b,
                                              int r, float factor, int* key) {
  float (*A)[8][9] = reinterpret_cast<float (*)[8][9]>(smem);
  float (*T)[8][9] = reinterpret_cast<float (*)[8][9]>(smem + KB * 8 * 9);
  const int tid = threadIdx.x;
  int c = 0;
  while (c + 1 < p.C && r >= p.ch[c + 1].item0) ++c;
  const Chan& ch = p.ch[c];
  const int local = r - ch.item0;
  const int cby = local / ch.nbx4;
  const int bx = (local % ch.nbx4) * KB + (tid & 31) / 8;
  const int u = tid >> 5, v = tid & 7, kb = (tid & 31) >> 3;
  const bool active = bx < ch.wc / 8;
  const int sy = ch.sy, sx = ch.sx, W = p.W;
  const size_t HW = (size_t)p.H * W;
  const size_t plane = ((size_t)b * p.C + c) * HW;
  float* f = p.f + plane;
  const float scale = scale_s[b * p.C + c];

  __syncthreads();   // the previous item is done with shared memory

  // 1. normalized step on this coefficient's footprint, summed for its mean
  const int py0 = cby * 8 * sy + u * sy, px0 = bx * 8 * sx + v * sx;
  float sum = 0.f;
  if (active) {
    for (int i = 0; i < sy; ++i)
      for (int j = 0; j < sx; ++j) {
        const size_t o = (size_t)(py0 + i) * W + (px0 + j);
        const float fv = ldcg(f + o);
        const float e = LITE ? fv + factor * side_ld<true>(p.fista, plane + o)
                             : fv + factor * (fv - side_ld<false>(p.fista, plane + o));
        sum += e - scale * side_ld<LITE>(p.grad, plane + o);
      }
  }
  const float mean = sum * (1.f / (float)(sy * sx));
  A[kb][u][v] = mean;
  __syncthreads();

  // 2. coefs = D m D^T
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s = __fmaf_rn(A[kb][u][j], Ds[v * 8 + j], s);
  T[kb][u][v] = s;
  __syncthreads();
  float coef = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) coef = __fmaf_rn(Ds[u * 8 + i], T[kb][i][v], coef);

  // 3. box from the int16 + quant rasters, projection, prob carry
  const size_t co = (size_t)b * ch.hc * ch.wc
                    + (size_t)(cby * 8 + u) * ch.wc + (bx * 8 + v);
  float cl = 0.f, dist = 0.f;
  if (active) {
    const float q = __ldg(ch.q + co);
    const float dq = (float)__ldg(ch.data + co) * q;
    cl = fminf(fmaxf(coef, dq - 0.5f * q), dq + 0.5f * q);
    if (ch.pidx >= 0) {
      const float iq = (q > 0.f && q < 549755813888.f) ? 1.f / q : 0.f;
      const float devp = (cl - dq) * iq;
      dist = devp * devp;
      side_st<LITE>(ch.devq, co, devp * iq);
    }
  }
  __syncthreads();   // every thread has read T before A / T are rewritten
  A[kb][u][v] = cl;
  __syncthreads();

  // 4. back = D^T clamp D
  s = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) s = __fmaf_rn(A[kb][u][k], Ds[k * 8 + v], s);
  T[kb][u][v] = s;
  __syncthreads();
  float back = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) back = __fmaf_rn(Ds[k * 8 + u], T[kb][k][v], back);

  // 5. the footprint: FISTA swap, fnew written once per pixel
  if (active) {
    for (int i = 0; i < sy; ++i)
      for (int j = 0; j < sx; ++j) {
        const size_t o = (size_t)(py0 + i) * W + (px0 + j);
        const float fv = ldcg(f + o);
        const float e = LITE ? fv + factor * side_ld<true>(p.fista, plane + o)
                             : fv + factor * (fv - side_ld<false>(p.fista, plane + o));
        const float fm = e - scale * side_ld<LITE>(p.grad, plane + o);
        const float fn = (fm - mean) + back;
        side_st<LITE>(p.fista, plane + o, LITE ? fn - fv : fv);
        f[o] = fn;
      }
  }

  *key = ch.pidx >= 0 ? b * NCOL + ch.pidx : -1;
  return dist;
}

// ---------------------------------------------------------------- the solve

// three co-resident blocks per SM (registers capped at 85 a thread, no
// spills; shared memory 63 KB a block at C = 3): the kernel is latency
// bound, and two blocks per SM hid too little of it (PERF.md)
constexpr int MIN_BLOCKS = 3;

template <int C, bool TGV, bool LITE>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) solve_kernel(Params p) {
  extern __shared__ float smem[];
  __shared__ float Ds[64];
  __shared__ float red[NT / 32];
  __shared__ float acc_s[MAXB * NCOL];
  __shared__ float scale_s[MAXB * MAXC];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = gridDim.x;
  const int Pd = p.P > 0 ? p.P : 1;
  if (tid < 64) Ds[tid] = c_D[tid];
  __syncthreads();

  for (int it = 0; it < p.nsteps; ++it) {
    const float factor = p.factors[it];

    // ---- gradient phase ----
    if (blockIdx.x == 0 && it > 0) write_dists(p, it - 1);
    for (int i = tid; i < MAXB * NCOL; i += NT) acc_s[i] = 0.f;
    __syncthreads();
    {
      // a block's tiles come in image order: sums flush per image
      float acc[C + 2];
      int cur = -1;
      for (int w = blockIdx.x; w < p.B * p.tiles_img; w += G) {
        const int b = w / p.tiles_img;
        if (b != cur) {
          if (cur >= 0) flush<C + 2>(acc, red, acc_s + cur * NCOL);
#pragma unroll
          for (int j = 0; j < C + 2; ++j) acc[j] = 0.f;
          cur = b;
        }
        grad_tile<C, TGV, LITE>(p, smem, Ds, b, w % p.tiles_img, factor, acc);
      }
      if (cur >= 0) flush<C + 2>(acc, red, acc_s + cur * NCOL);
    }
    __syncthreads();
    for (int i = tid; i < p.B * (C + 2); i += NT)
      p.gpart[(size_t)blockIdx.x * p.B * (C + 2) + i] =
          acc_s[(i / (C + 2)) * NCOL + i % (C + 2)];
    grid.sync();

    // ---- norms: every block, the same fixed order ----
    for (int k = warp; k < p.B * (C + 2); k += NT / 32) {
      const int b = k / (C + 2), j = k % (C + 2);
      const float s = warp_column_sum(p.gpart, G, p.B * (C + 2), k);
      if (lane == 0) {
        if (j < C) {
          const float n = sqrtf(s);
          scale_s[b * C + j] = n == 0.f ? 0.f : p.steps[b] / n;
        }
        if (blockIdx.x == 0) {
          const float val = j < C ? s : (j == C ? p.alpha * s
                                         : (TGV ? p.alpha2 * s : 0.f));
          p.out[((size_t)b * p.nsteps + it) * NCOL + j] = val;
        }
      }
    }
    for (int i = tid; i < MAXB * NCOL; i += NT) acc_s[i] = 0.f;
    __syncthreads();

    // ---- projection phase ----
    {
      // items come in (image, channel) order: distances flush per key
      float dacc[1] = {0.f};
      int cur = -1;
      for (int w = blockIdx.x; w < p.B * p.items_img; w += G) {
        int key;
        const float d = project_item<LITE>(p, smem, Ds, scale_s, w / p.items_img,
                                           w % p.items_img, factor, &key);
        if (key != cur) {
          if (cur >= 0) flush<1>(dacc, red, acc_s + cur);
          dacc[0] = 0.f;
          cur = key;
        }
        dacc[0] += d;
      }
      if (cur >= 0) flush<1>(dacc, red, acc_s + cur);
    }
    __syncthreads();
    for (int i = tid; i < p.B * Pd; i += NT)
      p.dpart[(size_t)blockIdx.x * p.B * Pd + i] =
          acc_s[(i / Pd) * NCOL + i % Pd];
    grid.sync();
  }
  if (blockIdx.x == 0 && p.nsteps > 0) write_dists(p, p.nsteps - 1);
}

template <int C, bool TGV, bool LITE>
cudaError_t prepare(size_t* bytes) {
  *bytes = Smem<C, TGV>::FLOATS * sizeof(float);
  static_assert(Smem<C, TGV>::FLOATS * sizeof(float) <= 200 * 1024,
                "tile exceeds a block's shared memory");
  return cudaFuncSetAttribute(solve_kernel<C, TGV, LITE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*bytes);
}

template <int C, bool TGV, bool LITE>
cudaError_t max_grid(int* blocks) {
  size_t bytes;
  cudaError_t err = prepare<C, TGV, LITE>(&bytes);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, solve_kernel<C, TGV, LITE>, NT, bytes);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms;
  return per_sm > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <int C, bool TGV, bool LITE>
cudaError_t launch(Params& p, int G, cudaStream_t stream) {
  int most = 0;
  cudaError_t err = max_grid<C, TGV, LITE>(&most);
  if (err != cudaSuccess) return err;
  if (G < 1 || G > most) return cudaErrorCooperativeLaunchTooLarge;
  size_t bytes;
  err = prepare<C, TGV, LITE>(&bytes);
  if (err != cudaSuccess) return err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((void*)solve_kernel<C, TGV, LITE>, dim3(G),
                                    dim3(NT), args, bytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the instantiations, indexed ((C - 1) * 2 + tgv) * 2 + lite
using GridFn = cudaError_t (*)(int*);
using LaunchFn = cudaError_t (*)(Params&, int, cudaStream_t);
#define J2P_VARIANTS(F)                                                     \
  {F<1, false, false>, F<1, false, true>, F<1, true, false>, F<1, true, true>, \
   F<2, false, false>, F<2, false, true>, F<2, true, false>, F<2, true, true>, \
   F<3, false, false>, F<3, false, true>, F<3, true, false>, F<3, true, true>, \
   F<4, false, false>, F<4, false, true>, F<4, true, false>, F<4, true, true>}
const GridFn kGrid[4 * MAXC] = J2P_VARIANTS(max_grid);
const LaunchFn kLaunch[4 * MAXC] = J2P_VARIANTS(launch);
#undef J2P_VARIANTS

int variant(int C, int tgv, int lite) {
  return ((C - 1) * 2 + (tgv ? 1 : 0)) * 2 + (lite ? 1 : 0);
}

}  // namespace

extern "C" {

const char* j2p_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Co-resident blocks of the cooperative launch for (C, tgv, lite) -> *blocks.
int j2p_fused_solve_grid(int C, int tgv, int lite, int* blocks) {
  if (C < 1 || C > MAXC) return (int)cudaErrorInvalidValue;
  return (int)kGrid[variant(C, tgv, lite)](blocks);
}

// f: [B, C, H, W] f32; fista, grad: [B, C, H, W] f32, or bf16 with lite
// (fista then holds d = f - fista); factors [nsteps]; ext [B, 2] int32;
// steps [B]; out [B, nsteps, 8] (zeroed by the caller); gpart [G, B, C+2];
// dpart [G, B, max(P, 1)].  ptrs[3c..3c+2]: data (int16), q (f32), devq
// (f32, lite: bf16) of channel c ([B, H/sy, W/sx]); ints[3c..3c+2]: sy,
// sx, prob index (-1: off); pa[c]: p_alpha.  G: grid blocks, at most
// j2p_fused_solve_grid's.  Returns the first CUDA error, else 0.
int j2p_fused_solve(float* f, void* fista, void* grad, const float* factors,
                    const int* ext, const float* steps, float* out,
                    float* gpart, float* dpart, const uint64_t* ptrs,
                    const int* ints, const float* pa, int B, int C, int H,
                    int W, int nsteps, int G, float alpha, float alpha2,
                    int tgv, int lite, void* stream) {
  if (C < 1 || C > MAXC || B < 1 || B > MAXB || nsteps < 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.f = f;
  p.fista = fista;
  p.grad = grad;
  p.factors = factors;
  p.ext = ext;
  p.steps = steps;
  p.out = out;
  p.gpart = gpart;
  p.dpart = dpart;
  p.B = B;
  p.C = C;
  p.H = H;
  p.W = W;
  p.nsteps = nsteps;
  p.alpha = alpha;
  p.alpha2 = alpha2;
  p.tiles_x = (W + TW - 1) / TW;
  p.tiles_img = p.tiles_x * ((H + TH - 1) / TH);
  int items = 0, P = 0;
  for (int c = 0; c < C; ++c) {
    Chan& ch = p.ch[c];
    ch.sy = ints[3 * c];
    ch.sx = ints[3 * c + 1];
    ch.pidx = ints[3 * c + 2];
    if (ch.sy < 1 || ch.sy > 4 || ch.sx < 1 || ch.sx > 4 ||
        H % (8 * ch.sy) || W % (8 * ch.sx) || 32 % (8 * ch.sx) ||
        (16 % (8 * ch.sy) && 8 * ch.sy % 16))
      return (int)cudaErrorInvalidValue;
    ch.data = (const int16_t*)ptrs[3 * c];
    ch.q = (const float*)ptrs[3 * c + 1];
    ch.devq = ch.pidx >= 0 ? (void*)ptrs[3 * c + 2] : nullptr;
    ch.pa = pa[c];
    ch.hc = H / ch.sy;
    ch.wc = W / ch.sx;
    ch.nbx4 = (ch.wc / 8 + KB - 1) / KB;
    ch.item0 = items;
    items += (ch.hc / 8) * ch.nbx4;
    P += ch.pidx >= 0;
  }
  p.items_img = items;
  p.P = P;
  if (nsteps == 0) return 0;
  return (int)kLaunch[variant(C, tgv, lite)](p, G, (cudaStream_t)stream);
}

}  // extern "C"
