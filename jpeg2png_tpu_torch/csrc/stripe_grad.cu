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
// Bound on an H100: device memory.  It moves 8 B per pixel and channel (f
// 4 B and d 2 B in, the bf16 gradient 2 B out) plus 2 B per prob
// coefficient (devq in), against ~150 flops per pixel and channel and ~32
// per prob coefficient.
//
// Design: K1's row-marching stencil (csrc/grad_step.cu), with the prob term
// expanded from devq inside the march.  A block of NT = 256 threads owns a
// column strip and a segment of the band's rows; thread i owns term column
// x0 - 1 + i and the block writes the NT - 2 output columns in between
// (strips overlap by 2 columns).  The block walks its segment one row per
// step:
//   1. 16-byte cp.async copies (zero-filled past the canvas and for null
//      halos) fill a ring of STAGES row slots, issued STAGES - LEAD steps
//      before their use: f of row r (4 columns a chunk, from floor4(x0 - 2))
//      and d (8 columns a chunk, from floor8(x0 - 2)), each from its own
//      16-byte aligned start.
//   2. e = f + factor * d of row t + LEAD goes into a 4-row ring.
//   3. the per-pixel terms of row t are computed once; only those a
//      neighbouring column reads (a, p, r) go to shared memory, in 4-row
//      rings; the rest stay in registers.
//   4. row t - 1 is gathered, its prob term added from the window below, and
//      the bf16 gradient written.
// The prob term: for each prob channel, the 8 coefficient rows of a devq
// block row under the strip are copied ahead by cp.async into a staging
// slot.  At the first gathered row of each block row (every 8 sy rows) the
// block transforms them once into a window of p_alpha * D^T devq D at
// coefficient resolution, every prob channel due at that row in one task
// list: the 8 lanes of an 8x8 block (one warp) each take one of its rows
// (row pass, from one 16-byte copy of the row), then, after a warp
// barrier, one of its columns (column pass, in place); each pass is an
// 8-point transform split into even and odd frequencies, D from constant
// memory.  No shuffles: they issue at a quarter of the FMA rate.  One block
// barrier, then the next block row's copies are issued (they have 8 sy >= 8
// steps to land).  Gathered row y, column x reads window[(y / sy) % 8][x /
// sx - wx0] through a per-thread column pointer, first in the gather so the
// loads overlap it: no pixel-resolution prob plane exists anywhere.
// Measured on an H100 (PERF.md): the prob phase costs a fifth of the
// kernel's time at 3072x2048 (0.186 ms, 0.148 without it); the march
// alone takes 2.9x the bytes bound: it issues K1's per-pixel instructions
// for 40% of K1's bytes.
// Strips stay K1's 254 columns, so they do not tile the coefficient blocks:
// a window covers every block the strip's columns touch, at most 33 for 31.75
// a strip at sx = 1.  The extra blocks cost about 4% more transforms, once
// per 8 sy rows; in exchange the kernel keeps K1's march, its op-for-op
// stencil and its grid.  (K3's cells, 128 whole-block columns and a helper
// warp for the two edge term columns, would tile the blocks exactly but need
// a second march of another shape.)  Segments may start inside a block row:
// the prologue transforms the block row of the segment's first row, so the
// grid is K1's (about one wave of resident blocks, segments of any length
// >= MIN_SEG rows).
// Rings: every e and term ring holds one row more than a step reads (K1's
// rule), so one barrier a row suffices.  The window is one slot per
// channel: it is rewritten only after the barrier that ends the gather of
// the previous block row's last row, and read only after the barrier that
// ends its rewrite (the one extra barrier at each row that starts a block
// row); the staging slot is refilled only after that same barrier.
// ~109 KB of shared memory per block at C = 3 with TGV2 (the windows sized
// for sx = 1): two blocks, 16 warps an SM, with registers capped to match.
// A block writes one row of partial sums; a second kernel reduces the rows
// in a fixed order (no float atomics, two runs give the same bits).
// j2p_grad_lite_partial_rows reports the number of rows, which sizes the
// caller's scratch.
// Built with -fmad=false like K1: the stencil rounds op for op like the
// plain PyTorch version, so without a prob term the bf16 outputs are equal;
// the transforms use explicit __fmaf_rn.  Requires W % 8 == 0 and 16-byte
// aligned f, d, halo and devq planes (the wrapper checks).

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;                  // threads per block, term columns
constexpr int OUTW = NT - 2;             // output columns per strip
constexpr int EWID = NT + 2;             // e ring row: columns x0-2 .. x0+NT-1
constexpr int SWID = EWID + 6;           // staged f row from floor4(x0 - 2)
constexpr int NCH = SWID / 4;            // 16-byte chunks of a staged f row
constexpr int DWID = EWID + 14;          // staged d row from floor8(x0 - 2)
constexpr int NCHD = DWID / 8;           // 16-byte chunks of a staged d row
static_assert(SWID == 4 * NCH && DWID == 8 * NCHD,
              "a staged row is whole 16-byte chunks");
constexpr int STAGES = 5;                // ring of staged rows
constexpr int LEAD = 3;                  // e is extrapolated LEAD rows ahead
constexpr int RING = 4;                  // rows of the e and term rings
static_assert(RING == 4 && LEAD + 1 == RING && STAGES > LEAD,
              "ring slots are taken mod 4: rows t-2 .. t+1 live, e of row "
              "t + LEAD into the slot of row t - 1");
// coefficient columns of a window: the blocks that a strip's columns touch
// at sx = 1 (its first column anywhere in a block)
constexpr int WMAX = 8 * ((7 + OUTW - 1) / 8 + 1);
static_assert(WMAX % 8 == 0, "a window row is whole blocks, 16-byte chunks");
constexpr int MIN_SEG = 16;              // shortest segment of rows
constexpr int MAXC = 4;
constexpr int HALO = 2;                  // rows of each halo array
constexpr int MAX_DEVICES = 64;

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
  float* part;             // [strips * segments, C + 2]
  const int* ext;          // [2] true (h, w), or null: HT, WT below
  int L, W, row0, HT, WT, seg;
  int pmask;               // bit c: channel c has a prob term
  float factor, alpha, alpha2;
  const uint16_t* devq[MAXC];  // [L/sy, W/sx] bf16, null when prob is off
  float pa[MAXC];          // p_alpha / (sy sx)
  int lsy[MAXC], lsx[MAXC];    // log2 of the footprint
};

// bytes of shared memory: the staged rows (f then d of every channel), the
// e ring, the rings of the terms a neighbouring column reads (a, p, r), the
// prob windows (f32) and the devq staging slots (bf16), [C][8][WMAX] each
template <int C, bool TGV>
struct Smem {
  static constexpr int STAGE = C * SWID * 4 + C * DWID * 2;
  static constexpr int E = RING * C * EWID;
  static constexpr int A = RING * C * NT;
  static constexpr int P = TGV ? RING * C * NT : 0;
  static constexpr int R = TGV ? RING * C * NT : 0;
  static constexpr int WIN = C * 8 * WMAX;
  static constexpr size_t BYTES =
      (size_t)STAGES * STAGE + 4 * (size_t)(E + A + P + R + WIN) + 2 * WIN;
  static_assert(STAGE % 16 == 0 && (E + A + P + R + WIN) % 4 == 0,
                "16-byte aligned regions");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
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

// Halo row r (r < 0: above the band, r >= L: below) of plane pl (f channels
// 0..C-1, then d), or null (zeros).
template <int C>
__device__ const char* halo_row(const Params& p, int pl, int r) {
  const bool isf = pl < C, above = r < 0;
  const int c = isf ? pl : pl - C;
  const size_t o = ((size_t)c * HALO + (above ? HALO + r : r - p.L)) * p.W;
  if (isf) {
    const float* h = above ? p.ftop : p.fbot;
    return h == nullptr ? nullptr : (const char*)(h + o);
  }
  const uint16_t* h = above ? p.dtop : p.dbot;
  return h == nullptr ? nullptr : (const char*)(h + o);
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

// out[i] = sum_u D[u][i] x[u], the 8-point inverse transform, split into
// the even and odd frequencies (D[u][7 - i] = (-1)^u D[u][i]): 32 fused
// multiply-adds and 8 adds instead of 64
__device__ __forceinline__ void idct8(const float (&x)[8], float (&out)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float ev = 0.f, od = 0.f;
#pragma unroll
    for (int u = 0; u < 8; u += 2) {
      ev = __fmaf_rn(c_D[u * 8 + i], x[u], ev);
      od = __fmaf_rn(c_D[(u + 1) * 8 + i], x[u + 1], od);
    }
    out[i] = ev + od;
    out[7 - i] = ev - od;
  }
}

template <int C, bool TGV>
__global__ void __launch_bounds__(NT, C <= 3 ? 2 : 1) grad_lite_kernel(Params p) {
  using S = Smem<C, TGV>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stage = smem;               // [STAGES][f: C][SWID], [d: C][DWID]
  float* e_s = (float*)(smem + STAGES * S::STAGE);   // [RING][C][EWID]
  float* a_s = e_s + S::E;                   // [RING][C][NT]  gx / |g|
  float* p_s = a_s + S::A;                   // [RING][C][NT]  TGV2 p
  float* r_s = p_s + S::P;                   // [RING][C][NT]  TGV2 r
  float* win = r_s + S::R;                   // [C][8][WMAX] p_alpha idct(devq)
  uint16_t* dqs = (uint16_t*)(win + S::WIN); // [C][8][WMAX] a devq block row
  __shared__ float red[(NT / 32) * (C + 2)];

  const int tid = threadIdx.x;
  const int L = p.L, W = p.W;
  const size_t LW = (size_t)L * W;
  const int HT = p.ext ? p.ext[0] : p.HT;
  const int WT = p.ext ? p.ext[1] : p.WT;
  // hl = h_true - row0 is the band row of the true bottom edge, top = -row0
  // the band row of global row 0
  const int hl = HT - p.row0, top = -p.row0;
  const int x0 = blockIdx.x * OUTW;
  const int s0 = blockIdx.y * p.seg, s1 = min(L, s0 + p.seg);
  const int xc = x0 - 1 + tid;               // this thread's column
  const int j = tid + 1;                     // its index in the e ring
  const bool own_col = tid >= 1 && tid < NT - 1 && xc < W;
  // a warp whose columns all lie past the canvas (in the last strip)
  // only copies rows and transforms: no term, e or gather of its columns
  // is read
  const bool live = x0 - 1 + (tid & ~31) < W;
  const int a0 = x0 >= 2 ? (x0 - 2) & ~3 : -4;   // first staged f column
  const int off = x0 - 2 - a0;               // e ring column 0 in a staged f row
  const int ad0 = x0 >= 2 ? (x0 - 2) & ~7 : -8;  // first staged d column
  const int offd = x0 - 2 - ad0;
  const int xl = min(x0 + OUTW, W) - 1;      // the strip's last output column
  // the prob channels (the prob phase runs only if there are any)
  const int pm = p.pmask;
  const bool prob = pm != 0;

  // this thread's 16-byte chunks of a staged row, fixed: plane (f channels,
  // then d channels; -1 none), column, and the plane's row 0 at that column
  constexpr int NF = C * NCH;
  constexpr int NLD = (C * (NCH + NCHD) + NT - 1) / NT;
  int ld_pl[NLD], ld_col[NLD];
  const char* ld_base[NLD];
#pragma unroll
  for (int k = 0; k < NLD; ++k) {
    const int i = tid + k * NT;
    int pl = -1, col = 0;
    if (i < NF) {
      pl = i / NCH;
      col = a0 + 4 * (i - pl * NCH);
    } else if (i < NF + C * NCHD) {
      const int c = (i - NF) / NCHD;
      pl = C + c;
      col = ad0 + 8 * (i - NF - c * NCHD);
    }
    ld_pl[k] = pl;
    ld_col[k] = col;
    ld_base[k] = pl < 0   ? nullptr
                 : pl < C ? (const char*)(p.f + (size_t)pl * LW + col)
                          : (const char*)(p.d + (size_t)(pl - C) * LW + col);
  }
  // stage slot `slot` takes f and d of row r while the segment reads them
  auto issue = [&](int r, int slot) {
    if (r <= s1 + 1) {
      const bool band = r >= 0 && r < L;
#pragma unroll
      for (int k = 0; k < NLD; ++k) {
        const int pl = ld_pl[k];
        if (pl < 0) continue;
        const size_t esz = pl < C ? 4 : 2;
        const char* src;
        if (band) {
          src = ld_base[k] + (size_t)r * W * esz;
        } else {                                  // a halo row, or zeros
          src = halo_row<C>(p, pl, r);
          if (src != nullptr) src += (long long)ld_col[k] * (long long)esz;
        }
        const bool ok = src != nullptr && ld_col[k] >= 0 && ld_col[k] < W;
        cp_async16(stage + slot * S::STAGE + 16 * (tid + k * NT),
                   ok ? (const void*)src : (const void*)p.f, ok ? 16 : 0);
      }
    }
    cp_async_commit();   // one group per row, empty past the segment
  };
  // e of one staged row into e ring slot `es`: this thread's column, and
  // the two outer columns (threads 0 and 1)
  auto extrapolate = [&](int es, int ss) {
    const float* fs = (const float*)(stage + ss * S::STAGE);
    const uint16_t* ds = (const uint16_t*)(stage + ss * S::STAGE + C * SWID * 4);
    float* er = e_s + es * C * EWID;
    auto one = [&](int jj) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        er[c * EWID + jj] =
            fs[c * SWID + jj + off] + p.factor * bf2f(ds[c * DWID + jj + offd]);
    };
    one(j);
    if (tid < 2) one(tid == 0 ? 0 : NT + 1);
  };

  // ---- the prob windows.  Channel c's window: coefficient columns wx0(c)
  //      .. wx0(c) + wcols(c) - 1, the whole blocks under the strip's
  //      output columns; rows: one devq block row.
  auto wx0_of = [&](int c) { return (x0 >> p.lsx[c]) & ~7; };
  auto wcols_of = [&](int c) { return ((xl >> p.lsx[c]) | 7) + 1 - wx0_of(c); };
  // copies of block row br of channel c into its staging slot
  auto load_dq = [&](int c, int br) {
    const int wx0 = wx0_of(c), nch = wcols_of(c) >> 3, wc = W >> p.lsx[c];
    const uint16_t* src = p.devq[c] + (size_t)(8 * br) * wc + wx0;
    uint16_t* dst = dqs + c * 8 * WMAX;
    // warp w copies row w, a 16-byte chunk a lane
    for (int q = tid & 31; q < nch; q += 32)
      cp_async16(dst + (tid >> 5) * WMAX + 8 * q,
                 src + (size_t)(tid >> 5) * wc + 8 * q, 16);
  };
  // the windows of the channels in `due` from their staging slots:
  // p_alpha * D^T devq D.  A lane per coefficient column, the channels'
  // columns in one task list; the 8 lanes of a block (aligned, in one warp)
  // first take its rows (row pass, T = devq D, from one 16-byte copy of the
  // row, into the window), then its columns (column pass, D^T T, in place)
  auto transform = [&](int due) {
    const int lane = tid & 31;
    int n[C];
    int tot = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      n[c] = (due >> c) & 1 ? wcols_of(c) : 0;
      tot += n[c];
    }
    for (int base = tid - lane; base < tot; base += NT) {
      const bool act = base + lane < tot;
      int c = 0, i = act ? base + lane : 0;
#pragma unroll
      for (int k = 0; k < C - 1; ++k)
        if (c == k && i >= n[k]) {
          i -= n[k];
          c = k + 1;
        }
      float pa = p.pa[0];
#pragma unroll
      for (int k = 1; k < C; ++k)
        if (c == k) pa = p.pa[k];
      const int b = i & ~7, r = i & 7;        // the block's first column; row
      float* wb = win + c * 8 * WMAX + b;     // and column of this lane
      if (act) {
        const uint4 raw =
            *(const uint4*)(dqs + (c * 8 + r) * WMAX + b);
        const float x[8] = {
            __uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
            __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u),
            __uint_as_float(raw.z << 16), __uint_as_float(raw.z & 0xffff0000u),
            __uint_as_float(raw.w << 16), __uint_as_float(raw.w & 0xffff0000u)};
        float t[8];
        idct8(x, t);
        float4* dst = (float4*)(wb + r * WMAX);
        dst[0] = make_float4(t[0], t[1], t[2], t[3]);
        dst[1] = make_float4(t[4], t[5], t[6], t[7]);
      }
      __syncwarp();
      if (act) {
        float t[8], o[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) t[u] = wb[u * WMAX + r];
        idct8(t, o);
#pragma unroll
        for (int ii = 0; ii < 8; ++ii) wb[ii * WMAX + r] = pa * o[ii];
      }
    }
  };

  // this thread's column in each channel's window (row 0)
  const float* wcol[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    wcol[c] = win + c * 8 * WMAX + (max(xc, 0) >> p.lsx[c]) - wx0_of(c);

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

  // prologue: the devq block rows of row s0 and rows s0-2 .. s0+STAGES-3 in
  // flight (the devq copies join the first row's group); e of rows s0-2 ..
  // s0 and the windows of row s0; then the next block rows' copies
  int due = 0;
  if (prob) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if ((pm >> c) & 1) {
        load_dq(c, s0 >> (3 + p.lsy[c]));
        due |= 1 << c;
      }
  }
#pragma unroll
  for (int k = 0; k < STAGES; ++k) issue(s0 - 2 + k, k);
  cp_async_wait<STAGES - LEAD>();
  __syncthreads();
#pragma unroll
  for (int k = 0; k < LEAD; ++k)
    if (live) extrapolate(k, k);
  if (due) transform(due);
  __syncthreads();
#pragma unroll
  for (int c = 0; c < C; ++c)
    if ((due >> c) & 1) {
      const int nb = (s0 >> (3 + p.lsy[c])) + 1;
      if ((nb << (3 + p.lsy[c])) < s1) load_dq(c, nb);
    }

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

    // ---- the windows of the prob channels whose block row starts at row y
    //      (the segment's first row had its windows in the prologue)
    if (prob && y > s0 && (y & 7) == 0) {
      int now = 0;
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (((pm >> c) & 1) && (y & ((8 << p.lsy[c]) - 1)) == 0)
          now |= 1 << c;
      if (now) {
        transform(now);
        __syncthreads();
#pragma unroll
        for (int c = 0; c < C; ++c)
          if ((now >> c) & 1) {
            const int nb = (y >> (3 + p.lsy[c])) + 1;
            if ((nb << (3 + p.lsy[c])) < s1) load_dq(c, nb);
          }
      }
    }

    // ---- gather of row y = t - 1 from the terms of rows t - 2 .. t
    const int ky = (k + 3) & 3;                // ring slot of row y
    if (own_col && t >= s0 + 1) {
      const int x = xc;
      const int r_dn = k, r_up = (k + 2) & 3;  // r slots of rows y+1, y-1
      const bool in_true = y < hl && x < WT;
      const bool up = y >= top + 1 && y - 1 < hl, down = y + 1 < hl;
      const bool left = x >= 1, right = x + 1 < W;
      const size_t o = (size_t)y * W + x;
      // the prob terms first, so their loads overlap the gather
      float pt[C];
#pragma unroll
      for (int c = 0; c < C; ++c)
        pt[c] = prob && ((pm >> c) & 1)
                    ? wcol[c][((y >> p.lsy[c]) & 7) * WMAX] : 0.f;
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
        if (!in_true) g = 0.f;   // padding stays frozen (stripe_grad.py:573-587)
        if (prob && ((pm >> c) & 1)) g = g + pt[c];
        p.grad[c * LW + o] = f2bf(g);
        acc[c] += g * g;
      }
    }
    // ---- e of row t + LEAD, into the slot of row y (this thread read its
    //      own column of it just above; no other thread reads it again)
    if (live && t + LEAD <= s1 + 1)
      extrapolate(ky, ks + LEAD < STAGES ? ks + LEAD : ks + LEAD - STAGES);
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

// Blocks of grad_lite_kernel<C, TGV> resident on the whole current device
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
  constexpr size_t bytes = Smem<C, TGV>::BYTES;
  static_assert(bytes <= 227 * 1024, "rings exceed a block's shared memory");
  // the opt-in above 48 KB counts the static arrays too: always ask
  err = cudaFuncSetAttribute(grad_lite_kernel<C, TGV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, grad_lite_kernel<C, TGV>, NT, bytes);
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
// rows each).  kernels/stripe_grad.py::lite_partial_rows mirrors it.
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
  grad_lite_kernel<C, TGV><<<grid, NT, Smem<C, TGV>::BYTES, stream>>>(p);
  return cudaGetLastError();
}

bool valid(int C, int L, int W) {
  return C >= 1 && C <= MAXC && L >= 1 && W >= 8 && W % 8 == 0;
}

}  // namespace

extern "C" {

const char* j2p_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Rows of partial sums (the `part` scratch of j2p_fused_grad_lite) for C
// channels, TGV2 on or off, a band of L x W on the current device; a
// negative value is -(the CUDA error).
int j2p_grad_lite_partial_rows(int C, int tgv, int L, int W) {
  if (!valid(C, L, W)) return -(int)cudaErrorInvalidValue;
  int slots = 0;
  const cudaError_t err = slots_for(C, tgv, &slots);
  if (err != cudaSuccess) return -(int)err;
  const Grid g = make_grid(slots, L, W);
  return g.strips * g.nseg;
}

// Rows of each segment of the same grid (the last one may be shorter), or
// -(the CUDA error): where a band's segment boundaries fall.
int j2p_grad_lite_segment_rows(int C, int tgv, int L, int W) {
  if (!valid(C, L, W)) return -(int)cudaErrorInvalidValue;
  int slots = 0;
  const cudaError_t err = slots_for(C, tgv, &slots);
  if (err != cudaSuccess) return -(int)err;
  return make_grid(slots, L, W).seg;
}

// f: [C, L, W] f32; d, grad: [C, L, W] bf16; ftop/fbot [C, 2, W] f32 and
// dtop/dbot [C, 2, W] bf16 or null (zeros); part: [j2p_grad_lite_partial_rows
// (C, tgv, L, W), C + 2] scratch; out: [C + 2] = (sum grad^2 per channel,
// tv, tv2); ext: [2] int32 true (h, w) on the device, or null for h_true /
// w_true.  devq[c]: [L/sy, W/sx] bf16 plane of channel c, 0 when its prob
// term is off; ints[2c..2c+1]: sy, sx; pa[c]: p_alpha.  alpha = 1/sqrt(C)
// and alpha2 = (weight/sqrt(2))/sqrt(C) come rounded from the caller; tgv
// = 0 skips the second-order term.  W % 8 == 0; f, d, the halos and the
// devq planes 16-byte aligned.  Returns the first CUDA error, else 0.
int j2p_fused_grad_lite(const float* f, const uint16_t* d, const float* ftop,
                        const float* fbot, const uint16_t* dtop,
                        const uint16_t* dbot, uint16_t* grad, float* part,
                        float* out, const int* ext, const uint64_t* devq,
                        const int* ints, const float* pa, int C, int L, int W,
                        int row0, int h_true, int w_true, float factor,
                        float alpha, float alpha2, int tgv, void* stream) {
  if (!valid(C, L, W)) return (int)cudaErrorInvalidValue;
  // a null halo pair reads as zeros: f and d halos go together
  if ((ftop == nullptr) != (dtop == nullptr) || (fbot == nullptr) != (dbot == nullptr))
    return (int)cudaErrorInvalidValue;
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
  p.pmask = 0;
  for (int c = 0; c < MAXC; ++c) {
    p.devq[c] = nullptr;
    p.pa[c] = 0.f;
    p.lsy[c] = p.lsx[c] = 0;
  }
  for (int c = 0; c < C; ++c) {
    const int sy = ints[2 * c], sx = ints[2 * c + 1];
    // footprints 1, 2 or 4 per axis, the band whole 8x8 blocks
    if ((sy != 1 && sy != 2 && sy != 4) || (sx != 1 && sx != 2 && sx != 4) ||
        L % (8 * sy) || W % (8 * sx))
      return (int)cudaErrorInvalidValue;
    p.lsy[c] = sy == 1 ? 0 : (sy == 2 ? 1 : 2);
    p.lsx[c] = sx == 1 ? 0 : (sx == 2 ? 1 : 2);
    p.devq[c] = (const uint16_t*)devq[c];
    p.pa[c] = pa[c];
    if (devq[c]) p.pmask |= 1 << c;
  }
  int slots = 0;
  cudaError_t err = slots_for(C, tgv, &slots);
  if (err != cudaSuccess) return (int)err;
  const Grid g = make_grid(slots, L, W);
  p.seg = g.seg;
  const dim3 grid(g.strips, g.nseg);
  cudaStream_t s = (cudaStream_t)stream;
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
  reduce_columns<<<C + 2, RT, 0, s>>>(part, g.strips * g.nseg, C + 2, out,
                                      alpha, tgv ? alpha2 : 0.f, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
