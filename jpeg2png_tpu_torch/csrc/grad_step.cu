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
// factor is a host float, or (K1 in the two tier's captured iteration,
// models/solver.py) read on the device as factors[*it]: an f32 table of
// the solve's FISTA factors and an int64 iteration index (int64 as
// PyTorch's index ops take it), so one captured CUDA graph replays every
// iteration.  The table holds the same f32 values
// the host float would carry, so the arithmetic is the same either way.
//
// K1 is the whole canvas as one band (row0 = 0, no halos).  K7 is a band of
// the row-striped solve: the two rows the stencil reaches past either band
// edge come from halo arrays [C, 2, W] of f and fista (the neighbouring
// bands' rows; null: zeros, the canvas edge), not from the TPU's 8-row DMA
// tiles, and every row mask keys on the global row row0 + band row.
//
// Bound on an H100: device memory.  It moves 4 * (4C + P) bytes per pixel
// (f, fista, pgrad in; grad, extrap out) against ~150 flops per pixel, and
// the instructions issued per pixel come close to that bound too.
//
// Design: a row-marching stencil.  A block of NT = 256 threads owns a
// column strip and a segment of the band's rows; thread i owns term column
// x0 - 1 + i and the block writes the NT - 2 output columns in between
// (strips overlap by 2 columns, so no thread does a second column's work).
// The block walks its segment from top to bottom, one row per step:
//   1. 16-byte cp.async copies (zero-filled past the canvas and for null
//      halos) fill a ring of STAGES row slots: f and fista of row r and the
//      prob gradient of row r - 4, issued STAGES - LEAD steps before their
//      use, so the next rows' loads are in flight while this row computes.
//   2. e of row t + LEAD goes into a 4-row ring (extrap is written from it
//      when its row is gathered; the stencil reaches one row down).
//   3. the per-pixel terms of row t (TV: g / |g|; TGV2: the p, q, r, center
//      terms of the 7-point scatter) are computed once.  Only the ones a
//      neighbouring column reads (a, p, r) go to shared memory, into 4-row
//      rings; b, q, the center term and the differences of the row above
//      stay in registers.
//   4. row t - 1 is gathered from the terms of rows t - 2 .. t and its prob
//      gradient row, and grad and extrap are written (each warp a
//      contiguous 128-byte line).
// Every input pixel is loaded once and every term computed once, except for
// 4 rows per segment and the 2 overlap columns per strip.  One barrier per
// row: every ring holds one row more than a step reads, so a thread a step
// ahead never overwrites a row a thread a step behind still reads.  No
// integer division per element (each thread's copy chunks are fixed).
// ~95 KB of shared memory per block at C = 3 with TGV2: two blocks, 16
// warps per SM, as the registers allow.  Segments are sized so that the
// grid is about one wave of resident blocks (occupancy x SMs), so a block
// writes one row of partial sums and the second pass reduces a few hundred
// rows, in a fixed order: no float atomics, so two runs give the same bits.
// j2p_grad_partial_rows reports the number of rows, which sizes the
// caller's scratch.  Warps whose columns all lie past the canvas (the last
// strip) only copy rows.
// Compiled with -fmad=false, the arithmetic rounds op for op like the plain
// PyTorch version, in the same order.  The edge masks follow
// jpeg2png_tpu/kernels/grad_step.py:96-138 and stripe_grad.py:188-262,
// including the pad row / column masks that apply when the true extent ends
// inside the canvas.  Requires W % 4 == 0 and 16-byte aligned f, fista,
// pgrad and halo arrays (every canvas is whole 8x8 blocks; the wrapper
// checks).

#include <atomic>

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;                  // threads per block, term columns
constexpr int OUTW = NT - 2;             // output columns per strip
constexpr int EWID = NT + 2;             // e ring row: columns x0-2 .. x0+NT-1
constexpr int SWID = EWID + 6;           // staged row from floor4(x0 - 2)
constexpr int NCH = SWID / 4;            // 16-byte chunks per staged row
static_assert(SWID == 4 * NCH, "a staged row is whole 16-byte chunks");
constexpr int STAGES = 5;                // ring of staged rows
constexpr int LEAD = 3;                  // e is extrapolated LEAD rows ahead
constexpr int PG_LAG = 4;                // slot of row r: prob gradient row r-4
constexpr int RING = 4;                  // rows of the e and term rings
static_assert(RING == 4 && LEAD + 1 == RING && PG_LAG == LEAD + 1 &&
                  STAGES > PG_LAG,
              "ring slots are taken mod 4: rows t-2 .. t+1 live, e of row "
              "t + LEAD into the slot of row t - 1, and the prob row of a "
              "gather in the stage slot of its e row");
constexpr int MIN_SEG = 16;              // shortest segment of rows
constexpr int MAXC = 4;
constexpr int HALO = 2;                  // rows of each halo array
constexpr int MAX_DEVICES = 64;

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
  float* part;          // [strips * segments, C + 2]
  const float* factors; // the factor table, or null: `factor` holds it
  const long long* it;  // index into `factors`
  int L, W, row0, HT, WT, seg, P;
  float factor, alpha, alpha2;
  int pidx[MAXC];       // prob plane of channel c, -1 when off
};

// floats of shared memory: the staged rows (f, fista and up to C prob
// gradient planes each), the e ring, and the rings of the terms a
// neighbouring column reads (a, p, r)
template <int C, bool TGV>
struct Smem {
  static constexpr int NPL = 3 * C;
  static constexpr int STAGE = NPL * SWID;
  static constexpr int E = RING * C * EWID;
  static constexpr int A = RING * C * NT;
  static constexpr int P = TGV ? RING * C * NT : 0;
  static constexpr int R = TGV ? RING * C * NT : 0;
  static constexpr int FLOATS = STAGES * STAGE + E + A + P + R;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Row r of plane pl (f channels 0..C-1, then fista): the band, a halo
// array, or null (zeros).
template <int C>
__device__ const float* row_src(const Params& p, int pl, int r) {
  const bool isf = pl < C;
  const int c = isf ? pl : pl - C;
  if (r >= 0 && r < p.L)
    return (isf ? p.f : p.fista) + ((size_t)c * p.L + r) * p.W;
  const float* h;
  int hr;
  if (r < 0) {
    h = isf ? p.ftop : p.fitop;
    hr = HALO + r;
  } else {
    h = isf ? p.fbot : p.fibot;
    hr = r - p.L;
  }
  return h == nullptr ? nullptr : h + ((size_t)c * HALO + hr) * p.W;
}

template <int N>
__device__ void block_sum(float (&v)[N], float* red, float* out) {
  // fixed-order reduction: warp tree, then thread j over the warp sums
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
  using S = Smem<C, TGV>;
  constexpr int NPL = S::NPL;
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                       // [STAGES][NPL][SWID]
  float* e_s = stage + STAGES * S::STAGE;    // [RING][C][EWID]
  float* a_s = e_s + S::E;                   // [RING][C][NT]  gx / |g|
  float* p_s = a_s + S::A;                   // [RING][C][NT]  TGV2 p
  float* r_s = p_s + S::P;                   // [RING][C][NT]  TGV2 r
  __shared__ float red[(NT / 32) * (C + 2)];

  const int tid = threadIdx.x;
  const int L = p.L, W = p.W, WT = p.WT;
  const size_t LW = (size_t)L * W;
  // hl = h_true - row0 is the band row of the true bottom edge, top = -row0
  // the band row of global row 0
  const int hl = p.HT - p.row0, top = -p.row0;
  const int x0 = blockIdx.x * OUTW;
  const int s0 = blockIdx.y * p.seg, s1 = min(L, s0 + p.seg);
  const int xc = x0 - 1 + tid;               // this thread's column
  const int j = tid + 1;                     // its index in the e ring
  const bool own_col = tid >= 1 && tid < NT - 1 && xc < W;
  // a warp whose columns all lie past the canvas (in the last strip)
  // only copies rows: no term, e or gather of its columns is read
  const bool live = x0 - 1 + (tid & ~31) < W;
  const int a0 = x0 >= 2 ? (x0 - 2) & ~3 : -4;   // first staged column
  const float factor = p.factors != nullptr ? p.factors[*p.it] : p.factor;
  const int off = x0 - 2 - a0;               // e ring column 0 in a stage

  // this thread's 16-byte chunks of a staged row, fixed: plane, column,
  // place in a stage slot, and the plane's row 0 at that column
  constexpr int NLD = (NPL * NCH + NT - 1) / NT;
  int ld_pl[NLD], ld_col[NLD], ld_dst[NLD];
  const float* ld_base[NLD];
#pragma unroll
  for (int k = 0; k < NLD; ++k) {
    const int i = tid + k * NT;
    const int pl = i < NPL * NCH ? i / NCH : NPL;
    ld_pl[k] = pl < 2 * C + p.P ? pl : -1;
    ld_col[k] = a0 + 4 * (i - pl * NCH);
    ld_dst[k] = 4 * i;                        // pl * SWID + 4 * chunk
    ld_base[k] = nullptr;
    if (ld_pl[k] >= 0)
      ld_base[k] = (pl < C       ? p.f + (size_t)pl * LW
                    : pl < 2 * C ? p.fista + (size_t)(pl - C) * LW
                                 : p.pgrad + (size_t)(pl - 2 * C) * LW) +
                   ld_col[k];
  }
  // stage slot `slot` takes f and fista of row r (while the segment reads
  // them) and the prob gradient of row r - PG_LAG (while it is an own row)
  auto issue = [&](int r, int slot) {
    const int rp = r - PG_LAG;
    const bool fe = r <= s1 + 1, pe = rp >= s0 && rp < s1;
    const bool band = r >= 0 && r < L;
#pragma unroll
    for (int k = 0; k < NLD; ++k) {
      const int pl = ld_pl[k];
      if (pl < 0) continue;
      const bool pg = pl >= 2 * C;
      if (pg ? !pe : !fe) continue;
      const float* src;
      if (pg || band) {
        src = ld_base[k] + (size_t)(pg ? rp : r) * W;
      } else {                                  // a halo row, or zeros
        src = row_src<C>(p, pl, r);
        if (src != nullptr) src += ld_col[k];
      }
      const bool ok = src != nullptr && ld_col[k] >= 0 && ld_col[k] < W;
      cp_async16(stage + slot * S::STAGE + ld_dst[k], ok ? src : p.f,
                 ok ? 16 : 0);
    }
    cp_async_commit();   // one group per row, empty past the segment
  };
  // e of one staged row into e ring slot `es`: this thread's column, and
  // the two outer columns (threads 0 and 1)
  auto extrapolate = [&](int es, int ss) {
    const float* fs = stage + ss * S::STAGE;
    float* er = e_s + es * C * EWID;
    auto one = [&](int jj) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float fv = fs[c * SWID + jj + off];
        const float fiv = fs[(C + c) * SWID + jj + off];
        er[c * EWID + jj] = fv + factor * (fv - fiv);
      }
    };
    one(j);
    if (tid < 2) one(tid == 0 ? 0 : NT + 1);
  };

  float acc[C + 2];
#pragma unroll
  for (int k = 0; k < C + 2; ++k) acc[k] = 0.f;
  // carried per channel: the differences of the row above (gxu, gyu) and
  // this column's b, q (rows t, t-1, t-2) and center terms (rows t, t-1)
  float gxu[C], gyu[C], b0[C], b1[C], b2[C], q0[C], q1[C], q2[C], c0[C],
      c1[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    gxu[c] = gyu[c] = b0[c] = b1[c] = b2[c] = 0.f;
    q0[c] = q1[c] = q2[c] = c0[c] = c1[c] = 0.f;
  }

  // prologue: rows s0-2 .. s0+STAGES-3 in flight, e of rows s0-2 .. s0
#pragma unroll
  for (int k = 0; k < STAGES; ++k) issue(s0 - 2 + k, k);
  cp_async_wait<STAGES - LEAD>();
  __syncthreads();
#pragma unroll
  for (int k = 0; k < LEAD; ++k)
    if (live) extrapolate(k, k);
  __syncthreads();

  // step t: the terms of row t, then the gather of row t - 1 and e of row
  // t + LEAD.  Ring slot of row t: k (e, a, p, r; rows t-2 .. t+1 live);
  // stage slot ks.  One barrier per step: every ring holds one row more
  // than the step reads, so a thread a step ahead writes no row that a
  // thread a step behind still reads.
  int k = 0, ks = 0;
  for (int t = s0 - 2; t <= s1; ++t) {
    issue(t + STAGES, ks);       // into the slot row t left
    const int y = t - 1;
    // ---- terms of row t
    if (live) {
      const float* et = e_s + k * C * EWID;
      const float* ed = e_s + ((k + 1) & 3) * C * EWID;
      float gx[C], gy[C];
      float gsq = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float e0 = et[c * EWID + j];
        // forward differences (grad_step.py:96-97)
        gx[c] = xc < WT - 1 ? et[c * EWID + j + 1] - e0 : 0.f;
        gy[c] = t < hl - 1 ? ed[c * EWID + j] - e0 : 0.f;
        const float term = gx[c] * gx[c] + gy[c] * gy[c];
        gsq = c == 0 ? term : gsq + term;
      }
      if (t >= s0 - 1) {
        const bool own = own_col && t >= s0 && t < s1;
        const float gn = sqrtf(gsq);
        const float inv = gn == 0.f ? 0.f : 1.f / gn;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          a_s[(k * C + c) * NT + tid] = gx[c] * inv;
          b2[c] = b1[c];
          b1[c] = b0[c];
          b0[c] = gy[c] * inv;
        }
        if (own) acc[C] += gn;
        if (TGV) {
          const bool yin = t >= top + 1 && t < hl;   // global row in [1, h_true)
          float g_xx[C], sym[C], g_yy[C];
          float n2sq = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float e0 = et[c * EWID + j];
            const float el = et[c * EWID + j - 1];
            // the differences at x - 1 (row t) and, carried, at row t - 1
            const float gxl = xc - 1 < WT - 1 ? e0 - el : 0.f;
            const float gyl = t < hl - 1 ? ed[c * EWID + j - 1] - el : 0.f;
            g_xx[c] = xc >= 1 ? gx[c] - gxl : 0.f;
            const float g_yx = (xc >= 1 && xc < WT) ? gy[c] - gyl : 0.f;
            const float g_xy = yin ? gx[c] - gxu[c] : 0.f;
            g_yy[c] = yin ? gy[c] - gyu[c] : 0.f;
            sym[c] = (g_xy + g_yx) * 0.5f;
            const float term = g_xx[c] * g_xx[c] + 2.f * sym[c] * sym[c]
                               + g_yy[c] * g_yy[c];
            n2sq = c == 0 ? term : n2sq + term;
          }
          const float n2 = sqrtf(n2sq);
          const float inv2 = n2 == 0.f ? 0.f : 1.f / n2;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            c1[c] = c0[c];
            c0[c] = -(2.f * g_xx[c] + 2.f * sym[c] + 2.f * g_yy[c]) * inv2;
            p_s[(k * C + c) * NT + tid] = (g_xx[c] + sym[c]) * inv2;
            q2[c] = q1[c];
            q1[c] = q0[c];
            q0[c] = (g_yy[c] + sym[c]) * inv2;
            r_s[(k * C + c) * NT + tid] = -sym[c] * inv2;
          }
          if (own) acc[C + 1] += n2;
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        gxu[c] = gx[c];
        gyu[c] = gy[c];
      }
    }
    cp_async_wait<STAGES - LEAD>();   // row t + LEAD has landed
    __syncthreads();

    // ---- gather of row y = t - 1 from the terms of rows t - 2 .. t
    const int ky = (k + 3) & 3;                // ring slot of row y
    const int sl = ks + LEAD < STAGES ? ks + LEAD : ks + LEAD - STAGES;
    const float* st = stage + sl * S::STAGE;   // row t + 3: prob row y
    if (own_col && t >= s0 + 1) {
      const int x = xc;
      const int r_dn = k, r_up = (k + 2) & 3;  // r slots of rows y+1, y-1
      const bool in_true = y < hl && x < WT;
      const bool up = y >= top + 1 && y - 1 < hl, down = y + 1 < hl;
      const bool left = x >= 1, right = x + 1 < W;
      const size_t o = (size_t)y * W + x;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float* ay = a_s + (ky * C + c) * NT;
        // TV: self -(a+b), from the left +a, from above +b (compute.c:98-104)
        const float a_l = left ? ay[tid - 1] : 0.f;
        const float b_u = up ? b2[c] : 0.f;
        float g = (-(ay[tid] + b1[c]) + a_l + b_u) * p.alpha;
        if (TGV) {
          const float* py = p_s + (ky * C + c) * NT;
          float g2 = c1[c];
          g2 = g2 + (right ? py[tid + 1] : 0.f);
          g2 = g2 + (left ? py[tid - 1] : 0.f);
          g2 = g2 + (down ? q0[c] : 0.f);
          g2 = g2 + (up ? q2[c] : 0.f);
          g2 = g2 + ((left && down) ? r_s[(r_dn * C + c) * NT + tid - 1] : 0.f);
          g2 = g2 + ((right && up) ? r_s[(r_up * C + c) * NT + tid + 1] : 0.f);
          g = g + p.alpha2 * g2;
        }
        if (!in_true) g = 0.f;   // padding stays frozen (grad_step.py:286-293)
        if (p.pidx[c] >= 0) g = g + st[(2 * C + p.pidx[c]) * SWID + j + off];
        p.grad[c * LW + o] = g;
        p.extrap[c * LW + o] = e_s[(ky * C + c) * EWID + j];
        acc[c] += g * g;
      }
    }
    // ---- e of row t + LEAD, into the slot of row y (this thread read its
    //      own column of it just above; no other thread reads it again)
    if (live && t + LEAD <= s1 + 1) extrapolate(ky, sl);
    k = (k + 1) & 3;
    ks = ks + 1 < STAGES ? ks + 1 : 0;
  }
  asm volatile("cp.async.wait_all;\n" ::);
  block_sum<C + 2>(acc, red,
                   p.part + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * (C + 2));
}

// out[j] = scale[j] * sum_b part[b, j], one block per column, fixed order.
constexpr int RT = 256;
__global__ void __launch_bounds__(RT)
reduce_columns(const float* part, int nrows, int ncols, float* out,
               float scale_tv, float scale_tv2, int C) {
  __shared__ float red[RT];
  const int j = blockIdx.x;
  float s = 0.f;
  for (int b = threadIdx.x; b < nrows; b += RT) s += part[(size_t)b * ncols + j];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = RT / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float scale = j == C ? scale_tv : (j == C + 1 ? scale_tv2 : 1.f);
    out[j] = scale * red[0];
  }
}

template <int C, bool TGV>
constexpr size_t smem_bytes() {
  return Smem<C, TGV>::FLOATS * sizeof(float);
}

// Blocks of grad_kernel<C, TGV> resident on the whole current device
// (occupancy x SMs), cached per device.
template <int C, bool TGV>
cudaError_t resident_blocks(int* slots) {
  // stored by whichever host thread launches first on a device, read by
  // all (one thread per card in the serving runner): atomic; racing
  // threads store the same value
  static std::atomic<int> cached[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int known = dev < MAX_DEVICES ? cached[dev].load() : 0;
  if (known > 0) {
    *slots = known;
    return cudaSuccess;
  }
  constexpr size_t bytes = smem_bytes<C, TGV>();
  static_assert(bytes <= 227 * 1024, "ring exceeds a block's shared memory");
  // the opt-in above 48 KB counts the static `red` array too: always ask
  err = cudaFuncSetAttribute(grad_kernel<C, TGV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, grad_kernel<C, TGV>, NT, bytes);
  if (err != cudaSuccess) return err;
  *slots = (per_sm > 0 ? per_sm : 1) * sms;
  if (dev < MAX_DEVICES) cached[dev].store(*slots);
  return cudaSuccess;
}

cudaError_t slots_for(int C, int tgv, int* slots) {
  switch (C * 2 + (tgv ? 1 : 0)) {
    case 2: return resident_blocks<1, false>(slots);
    case 3: return resident_blocks<1, true>(slots);
    case 4: return resident_blocks<2, false>(slots);
    case 5: return resident_blocks<2, true>(slots);
    case 6: return resident_blocks<3, false>(slots);
    case 7: return resident_blocks<3, true>(slots);
    case 8: return resident_blocks<4, false>(slots);
    default: return resident_blocks<4, true>(slots);
  }
}

// The grid: strips of OUTW columns, and segments of rows sized so that
// strips x segments is about one wave of resident blocks (at least MIN_SEG
// rows each).  kernels/grad_step.py::partial_rows mirrors it.
struct Grid {
  int strips, nseg, seg;
};
Grid make_grid(int slots, int L, int W) {
  Grid g;
  g.strips = (W + OUTW - 1) / OUTW;
  int target = slots / g.strips;
  if (target < 1) target = 1;
  g.seg = (L + target - 1) / target;
  if (g.seg < MIN_SEG) g.seg = MIN_SEG;
  g.nseg = (L + g.seg - 1) / g.seg;
  return g;
}

template <int C, bool TGV>
cudaError_t launch(const Params& p, dim3 grid, cudaStream_t stream) {
  grad_kernel<C, TGV><<<grid, NT, smem_bytes<C, TGV>(), stream>>>(p);
  return cudaGetLastError();
}

// Launches the gradient kernel and the fixed-order reduction of its
// partial sums; returns the first CUDA error, else 0.
int run(Params& p, int C, int tgv, float* out, cudaStream_t s) {
  if (C < 1 || C > MAXC || p.L < 1 || p.W < 4 || p.W % 4 != 0)
    return (int)cudaErrorInvalidValue;
  // a null halo pair reads as zeros: f and fista halos go together
  if ((p.ftop == nullptr) != (p.fitop == nullptr) ||
      (p.fbot == nullptr) != (p.fibot == nullptr))
    return (int)cudaErrorInvalidValue;
  p.P = 0;
  for (int c = 0; c < C; ++c) {
    if (p.pidx[c] >= C || (p.pidx[c] >= 0) != (p.pidx[c] == p.P))
      return (int)cudaErrorInvalidValue;   // planes 0..P-1 in channel order
    if (p.pidx[c] >= 0) ++p.P;
  }
  if (p.P > 0 && p.pgrad == nullptr) return (int)cudaErrorInvalidValue;
  if ((p.factors == nullptr) != (p.it == nullptr))
    return (int)cudaErrorInvalidValue;
  int slots = 0;
  cudaError_t err = slots_for(C, tgv, &slots);
  if (err != cudaSuccess) return (int)err;
  const Grid g = make_grid(slots, p.L, p.W);
  p.seg = g.seg;
  const dim3 grid(g.strips, g.nseg);
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
  reduce_columns<<<C + 2, RT, 0, s>>>(p.part, g.strips * g.nseg, C + 2, out,
                                      p.alpha, tgv ? p.alpha2 : 0.f, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* j2p_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Rows of partial sums (the `part` scratch of j2p_fused_grad_striped) for
// C channels, TGV2 on or off, a band of L x W on the current device; a
// negative value is -(the CUDA error).
int j2p_grad_partial_rows(int C, int tgv, int L, int W) {
  if (C < 1 || C > MAXC || L < 1 || W < 1) return -(int)cudaErrorInvalidValue;
  int slots = 0;
  const cudaError_t err = slots_for(C, tgv, &slots);
  if (err != cudaSuccess) return -(int)err;
  const Grid g = make_grid(slots, L, W);
  return g.strips * g.nseg;
}

// Rows of each segment of the same grid (the last one may be shorter), or
// -(the CUDA error): where a band's segment boundaries fall.
int j2p_grad_segment_rows(int C, int tgv, int L, int W) {
  if (C < 1 || C > MAXC || L < 1 || W < 1) return -(int)cudaErrorInvalidValue;
  int slots = 0;
  const cudaError_t err = slots_for(C, tgv, &slots);
  if (err != cudaSuccess) return -(int)err;
  return make_grid(slots, L, W).seg;
}

// A band of L rows of a [C, h_pad, W] canvas, its first row global row
// row0 (K1: the whole canvas, row0 = 0, null halos); f, fista, pgrad
// ([P, L, W]), grad, extrap: band tensors; ftop / fbot and fitop / fibot:
// [C, 2, W] halo rows of f and fista just above / below the band, null for
// zeros (the canvas edge).  W % 4 == 0; f, fista and the halos 16-byte
// aligned.  part: [j2p_grad_partial_rows(C, tgv, L, W), C + 2] scratch;
// out: [C + 2] = the band's (sum grad^2 per channel, tv, tv2).  factors,
// it: null for the host float `factor`, else the FISTA factor is read on
// the device as factors[*it] (f32 table, int64 index).  alpha =
// 1/sqrt(C) and alpha2 = (weight/sqrt(2))/sqrt(C) come from the caller,
// rounded once to f32 as the plain version rounds them; tgv = 0 skips the
// second-order term.  Returns the first CUDA error, else 0.
int j2p_fused_grad_table(const float* f, const float* fista,
                         const float* ftop, const float* fbot,
                         const float* fitop, const float* fibot,
                         const float* pgrad, float* grad, float* extrap,
                         float* part, float* out, int C, int L, int W,
                         int row0, int h_true, int w_true, float factor,
                         const float* factors, const long long* it,
                         float alpha,
                         float alpha2, int tgv, int pidx0, int pidx1,
                         int pidx2, int pidx3, void* stream) {
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
  p.factors = factors;
  p.it = it;
  p.L = L;
  p.W = W;
  p.row0 = row0;
  p.HT = h_true;
  p.WT = w_true;
  p.seg = 0;
  p.P = 0;
  p.factor = factor;
  p.alpha = alpha;
  p.alpha2 = alpha2;
  p.pidx[0] = pidx0;
  p.pidx[1] = pidx1;
  p.pidx[2] = pidx2;
  p.pidx[3] = pidx3;
  return run(p, C, tgv, out, (cudaStream_t)stream);
}

// The same with the factor a host float (no table).
int j2p_fused_grad_striped(const float* f, const float* fista,
                           const float* ftop, const float* fbot,
                           const float* fitop, const float* fibot,
                           const float* pgrad, float* grad, float* extrap,
                           float* part, float* out, int C, int L, int W,
                           int row0, int h_true, int w_true, float factor,
                           float alpha, float alpha2, int tgv, int pidx0,
                           int pidx1, int pidx2, int pidx3, void* stream) {
  return j2p_fused_grad_table(f, fista, ftop, fbot, fitop, fibot, pgrad, grad,
                              extrap, part, out, C, L, W, row0, h_true,
                              w_true, factor, nullptr, nullptr, alpha, alpha2,
                              tgv, pidx0, pidx1, pidx2, pidx3, stream);
}

}  // extern "C"
