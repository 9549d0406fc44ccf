// K3: the whole solve (all iterations of a chunk) in one launch, for Hopper.
//
// Replaces the Pallas kernel jpeg2png_tpu/kernels/iter_step.py::fused_solve
// (_kernel).  For B images padded into one [H, W] bucket canvas with C
// channels, runs nsteps iterations of the port's two-kernel body (K1
// csrc/grad_step.cu + K2 csrc/project_step.cu; reference compute.c:406-465):
//
//   gradient phase:
//     e     = f + factor * (f - fista)
//     grad  = alpha * TV gather + alpha2 * TGV2 gather of e, zeroed outside
//             the image's true extent, + p_alpha * up(idct(devq))
//   grid barrier; every block reduces sumsq per image and channel in one
//   fixed order and takes scale = step / sqrt(sumsq) (0 at zero norm)
//   projection phase, per coefficient:
//     fmid  = e - scale * grad
//     clamp = clip(D mean(fmid) D^T, lo, hi), lo/hi from data * q -+ q / 2
//     fnew  = (fmid - up(mean)) + up(D^T clamp D)
//     devp  = (clamp - dq) * iq, devq = devp * iq, dist += devp^2
//     fista = f, f = fnew                (the FISTA swap, in place)
//   grid barrier
//
// q == 0 marks frozen canvas padding (box [0, 0], iq = 0) and q >= 2^39
// a region gap (unconstrained box, iq = 0): project_step.py:658-664.
//
// Bound on an H100: device memory for buckets larger than the 50 MB L2,
// latency below that.  Streaming the state costs, per iteration and
// pixel-channel, f and fista read by the gradient phase, f and fista read
// and written by the projection (24 B), and grad written and read (8 B;
// lite: 4) unless it stays in shared memory.
//
// Design: one persistent cooperative launch.  The canvas of each image is
// cut into cells of CW = 128 columns and RH rows (RH a multiple of 8 *
// max(sy), so a cell is whole 8x8 coefficient blocks of every channel);
// block g owns cells [g k, g k + k) for the whole launch (k = 1 unless the
// canvas has more cells than co-resident blocks).  RH is chosen on the host
// so that the cells are about one wave of co-resident blocks, and at least
// 16 rows; the blocks are exactly the cells' owners.  Per iteration a block
//   1. marches its cells' rows with K1's row-marching stencil
//      (csrc/grad_step.cu: 16-byte cp.async copies of f and fista rows into
//      a 5-slot ring, e extrapolated 3 rows ahead, the per-pixel terms once
//      per row in 4-row rings, one barrier a row).  A thread owns one output
//      column; the two term columns on either side of the cell come from a
//      fifth, helper warp (two of its lanes), so cells tile the canvas
//      without overlap and stay aligned to the coefficient blocks.  The
//      gradient goes to the block's own scratch, never to a canvas-sized
//      array, and the prob gradient comes from the block's window of
//      p_alpha * idct(devq) at coefficient resolution, which the same block
//      wrote in its previous projection (the launch's first iteration: a
//      prologue transforms the devq input);
//   2. writes one row of per-image partial sums (one fused block tree for
//      the C + 2 sums);
//   3. after the grid barrier, reads its images' blocks' rows once,
//      contiguously, into shared memory and sums each column in one fixed
//      order (the same in every block: no float atomics, two runs give the
//      same bits); the previous iteration's distance columns are spread
//      over the blocks;
//   4. projects its cells, a band of 8 max(sy) rows at a time: 16-byte
//      cp.async copies bring the band's f, side values and (global scratch)
//      gradient rows into shared tiles, one wait; then one thread per
//      coefficient column of an 8x8 block row computes fmid once per pixel,
//      the means, the forward transform (column pass in registers, row pass
//      by shuffles across the block's 8 lanes), the box, devq, the inverse
//      transforms (fnew's and the next prob window's), and writes fnew and
//      the FISTA swap straight to the canvas.  A warp's lanes share one
//      channel, so the footprint loops unroll (templates for 1x1, 2x2, 1x2,
//      2x1); larger footprints go first.  Two block barriers a band;
//   5. the second grid barrier.
// The block's scratch (its cells' gradient and prob windows) lives in
// shared memory when every cell's block fits co-resident with it (a
// photo-size canvas), else in a global array of the same layout that only
// the block itself reads.  Blocks whose cells lie wholly in a bucket
// image's padding skip both phases: with q == 0 and a zero state there
// the plain body also leaves exact zeros.  Buffers written inside the
// launch are read through L2 (cp.async.cg, ld.global.cg).  Measured on an
// H100 (PERF.md): a grid barrier takes 1.2-1.4 us of an iteration at
// photo512 (about 5%), so the second one stays; the scratch in shared
// memory saves about 4% there; three blocks an SM (registers capped at
// 128, a few hundred bytes of spills) beat two above photo size.
// Built with -fmad=false like K1, so the stencil rounds op for op like the
// plain PyTorch version; the transforms use explicit __fmaf_rn.
//
// Lite mode (LITE = true; the TPU kernel's lite=True, iter_step.py:664-670,
// 696-704, 758-761): the side buffers hold bf16 in place of f32 — the FISTA
// shadow becomes the difference d = f - fista (e = f + factor * d), the
// gradient and devq are rounded to bf16 where they are stored (sumsq from
// the f32 gradient; the prob window from the rounded devq), and the swap
// writes d = bf16(fnew - f).  One template on the side buffers' storage
// type; an iteration equals K4 (csrc/stripe_grad.cu) then K5
// (csrc/project_lite.cu).
//
// The row-marching stencil is a copy of K1's, not a shared header: the
// helper warp, the bf16 side planes, the per-image extents, the scratch
// output and the prob window change every line of it that K1 would share.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CW = 128;                  // output columns of a cell
constexpr int NTH = CW + 32;             // one thread a column + a helper warp
constexpr int NW = NTH / 32;
constexpr int TC = CW + 2;               // term columns x0-1 .. x0+CW
constexpr int EWID = CW + 4;             // e ring row: columns x0-2 .. x0+CW+1
constexpr int SWID = CW + 16;            // staged row: columns x0-8 .. x0+CW+7
constexpr int SOFF = 6;                  // e ring column 0 in a staged row
constexpr int STAGES = 5;                // ring of staged rows
constexpr int LEAD = 3;                  // e is extrapolated LEAD rows ahead
constexpr int RING = 4;                  // rows of the e and term rings
static_assert(RING == 4 && LEAD + 1 == RING && STAGES > LEAD,
              "ring slots are taken mod 4: rows t-1 .. t+2 live, e of row "
              "t + LEAD into the slot of row t - 1");
constexpr int MIN_RH = 16;               // shortest cell
constexpr int MAXC = 4, MAXB = 8, NCOL = 8;
constexpr int MIN_BLOCKS = 3;            // registers capped for 3 blocks an SM
constexpr bool ALLOW_RESIDENT = true;    // scratch in shared memory if it fits
constexpr int MAX_SMEM = 226 * 1024;     // dynamic shared memory of a block
constexpr float FREE_Q = 549755813888.f; // 2^39

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
  int sy, sx, lsy, lsx, hc, wc;
  int woff;             // first float of this channel's window in a cell
};

struct Params {
  float* f;             // [B, C, H, W] iterate, updated in place
  void* side;           // [B, C, H, W] FISTA shadow (lite: bf16 d = f - fista)
  unsigned char* scratch;  // [G, k, cell_bytes] when not resident, else null
  const float* factors; // [nsteps]
  const int* ext;       // [B, 2] true (h, w)
  const float* steps;   // [B] step size
  float* out;           // [B, nsteps, NCOL] partials rows
  float* gpart;         // [B, G, C + 2] per-block gradient sums
  float* dpart;         // [2, B, G, max(P, 1)] per-block distance sums
  int B, C, H, W, nsteps, P;
  int strips, segs, RH, ncell, k, G, resident;
  int phase_bytes, cell_bytes, grad_bytes;
  int ay;               // rows of a projection band: 8 max(sy)
  float alpha, alpha2;
  Chan ch[MAXC];
};

// ------------------------------------------------------------ side buffers

template <bool LITE> struct Side { using T = float; };
template <> struct Side<true> { using T = uint16_t; };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float((uint32_t)v << 16);
}
template <bool LITE>
__device__ __forceinline__ typename Side<LITE>::T narrow(float v) {
  if constexpr (LITE)
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  else
    return v;
}
__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ uint16_t ldcg(const uint16_t* p) {
  return __ldcg((const unsigned short*)p);
}

// a scratch element: shared memory, or the block's global array read
// through L2 like every buffer written inside the launch
template <typename T>
__device__ __forceinline__ float scr_ld(const T* ptr, bool resident) {
  return widen(resident ? *ptr : ldcg(ptr));
}

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

// ------------------------------------------------------------ shared memory

// bytes of the gradient phase's rings: staged rows (f, then the side
// planes), the e ring, and the rings of the terms a neighbouring column
// reads (a; TGV2 p and r)
template <int C, bool TGV, bool LITE>
struct Ring {
  using T = typename Side<LITE>::T;
  static constexpr int SIDE = sizeof(T);
  static constexpr int FCH = SWID / 4;             // 16-byte chunks, f row
  static constexpr int SCH = SWID * SIDE / 16;     // 16-byte chunks, side row
  static constexpr int NCH = C * (FCH + SCH);
  static constexpr int NLD = (NCH + NTH - 1) / NTH;
  static constexpr int SLOT = C * SWID * (4 + SIDE);
  static constexpr int STAGE_BYTES = STAGES * SLOT;
  static constexpr int E_FLOATS = RING * C * EWID;
  static constexpr int T_FLOATS = RING * C * TC;
  static constexpr int BYTES =
      STAGE_BYTES + 4 * (E_FLOATS + (TGV ? 3 : 1) * T_FLOATS);
  static_assert(SLOT % 16 == 0 && (SWID * SIDE) % 16 == 0,
                "stage rows are whole 16-byte chunks");
};

// bytes of the projection's band tiles [C][ay][CW]: the old f (f32), the
// side values and the gradient (f32, lite: bf16 each), and in lite mode
// fmid (f32; in f32 mode it takes the side values' place): 12 bytes a
// pixel and channel in both modes
__host__ __device__ constexpr int proj_bytes(int C, int ay) {
  return 12 * C * ay * CW;
}

// ------------------------------------------------------------ block sums

// out[j] = fixed-order block sum of v[j] for j < n (thread j writes):
// warp trees, then thread j over the warps.  Ends with a barrier, so
// `red` may be reused at once.
template <int N>
__device__ void block_sum(const float (&v)[N], float* red, float* out, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float s = v[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) red[warp * N + j] = s;
  }
  __syncthreads();
  if ((int)threadIdx.x < n) {
    float s = 0.f;
    for (int w = 0; w < NW; ++w) s += red[w * N + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// sum of rows r0..r1 of column `col` of a [rows, stride] buffer, by one
// warp in one fixed order (lane-strided, then a shuffle tree) -> lane 0
__device__ float warp_column_sum(const float* buf, int r0, int r1, int stride,
                                 int col) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
#pragma unroll 4
  for (int g = r0 + lane; g <= r1; g += 32)
    s += __ldcg(buf + (size_t)g * stride + col);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  return s;
}

// ------------------------------------------------------------ cells

struct Cell {
  int b, x0, s0, s1, cw;
  bool live;            // not wholly in the image's padding
  unsigned char* scr;   // the cell's scratch: grad [C][RH][CW], windows
};

__device__ __forceinline__ Cell cell_at(const Params& p, int n,
                                        unsigned char* scr) {
  Cell c;
  const int cpi = p.strips * p.segs;
  c.b = n / cpi;
  const int r = n - c.b * cpi;
  const int seg = r / p.strips, strip = r - seg * p.strips;
  c.x0 = strip * CW;
  c.s0 = seg * p.RH;
  c.s1 = min(p.H, c.s0 + p.RH);
  c.cw = min(CW, p.W - c.x0);
  c.live = c.s0 < p.ext[2 * c.b] && c.x0 < p.ext[2 * c.b + 1];
  c.scr = scr;
  return c;
}

// first and last block holding cells of image b
__device__ __forceinline__ int first_block(const Params& p, int b) {
  return b * p.strips * p.segs / p.k;
}
__device__ __forceinline__ int last_block(const Params& p, int b) {
  return ((b + 1) * p.strips * p.segs - 1) / p.k;
}

// ------------------------------------------------------------ gradient

// The cell's rows s0 .. s1-1: grad into the cell's scratch, the sums into
// acc (sumsq per channel from the f32 value, tv, tv2 over own pixels).
template <int C, bool TGV, bool LITE>
__device__ void march(const Params& p, const Cell& cell, float factor,
                      unsigned char* smem, float (&acc)[C + 2]) {
  using R = Ring<C, TGV, LITE>;
  using T = typename R::T;
  unsigned char* stage = smem;
  float* e_s = (float*)(smem + R::STAGE_BYTES);   // [RING][C][EWID]
  float* a_s = e_s + R::E_FLOATS;                 // [RING][C][TC] gx / |g|
  float* p_s = a_s + R::T_FLOATS;                 // [RING][C][TC] TGV2 p
  float* r_s = p_s + R::T_FLOATS;                 // [RING][C][TC] TGV2 r

  const int tid = threadIdx.x, lane = tid & 31;
  const int H = p.H, W = p.W, b = cell.b, x0 = cell.x0, s0 = cell.s0,
            s1 = cell.s1;
  const int HT = p.ext[2 * b], WT = p.ext[2 * b + 1];
  const size_t HW = (size_t)H * W;
  const float* fb = p.f + (size_t)b * C * HW;
  const T* sb = (const T*)p.side + (size_t)b * C * HW;
  T* gs = (T*)cell.scr;
  const float* win = (const float*)(cell.scr + p.grad_bytes);
  // term column tj (ring index; column x0 - 1 + tj): own threads the cell's
  // columns, helper lanes 0 and 1 the columns on either side
  const bool helper = tid >= CW;
  const int tj = helper ? (lane == 0 ? 0 : (lane == 1 ? CW + 1 : -1))
                        : tid + 1;
  const bool term = tj >= 0;
  const int ej = tj + 1;                     // its e ring column
  const int xc = x0 - 1 + tj;
  const bool own_col = !helper && x0 + tid < W;
  // an own warp whose columns all lie past the canvas only copies rows
  const bool live = helper || x0 + (tid & ~31) < W;
  const int a0 = x0 - 8;                     // first staged column

  // this thread's 16-byte chunks of a staged row: source (row 0), bytes per
  // element, place in a slot; -1: none
  const char* ld_src[R::NLD];
  int ld_dst[R::NLD], ld_esz[R::NLD];
  bool ld_ok[R::NLD];
#pragma unroll
  for (int k = 0; k < R::NLD; ++k) {
    const int i = tid + k * NTH;
    ld_dst[k] = -1;
    ld_src[k] = nullptr;
    ld_esz[k] = 4;
    ld_ok[k] = false;
    if (i < C * R::FCH) {
      const int c = i / R::FCH, q = i - c * R::FCH, col = a0 + 4 * q;
      ld_dst[k] = c * SWID * 4 + 16 * q;
      ld_ok[k] = col >= 0 && col < W;
      ld_src[k] = (const char*)(fb + c * HW + (ld_ok[k] ? col : 0));
    } else if (i < R::NCH) {
      const int i2 = i - C * R::FCH, c = i2 / R::SCH, q = i2 - c * R::SCH;
      const int col = a0 + q * (16 / R::SIDE);
      ld_dst[k] = C * SWID * 4 + c * SWID * R::SIDE + 16 * q;
      ld_ok[k] = col >= 0 && col < W;
      ld_src[k] = (const char*)(sb + c * HW + (ld_ok[k] ? col : 0));
      ld_esz[k] = R::SIDE;
    }
  }
  // stage slot `slot` takes f and the side planes of row r (zeros outside
  // the canvas) while the march reads them
  auto issue = [&](int r, int slot) {
    if (r <= s1 + 1) {
      const bool in = r >= 0 && r < H;
#pragma unroll
      for (int k = 0; k < R::NLD; ++k) {
        if (ld_dst[k] < 0) continue;
        const bool ok = in && ld_ok[k];
        cp_async16(stage + slot * R::SLOT + ld_dst[k],
                   ok ? ld_src[k] + (size_t)r * W * ld_esz[k]
                      : (const char*)fb,
                   ok ? 16 : 0);
      }
    }
    cp_async_commit();   // one group per row, empty past the cell
  };
  // e of one staged row into e ring slot `es`: own threads their column,
  // helper lanes 0-3 the two columns on either side
  auto extrapolate = [&](int es, int ss) {
    const float* fs = (const float*)(stage + ss * R::SLOT);
    const T* ds = (const T*)(stage + ss * R::SLOT + C * SWID * 4);
    float* er = e_s + es * C * EWID;
    auto one = [&](int jj) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float fv = fs[c * SWID + jj + SOFF];
        const float sv = widen(ds[c * SWID + jj + SOFF]);
        er[c * EWID + jj] = LITE ? fv + factor * sv : fv + factor * (fv - sv);
      }
    };
    if (!helper)
      one(tid + 2);
    else if (lane < 4)
      one(lane < 2 ? lane : CW + lane);
  };

  // carried per channel: the differences of the row above (gxu, gyu) and
  // this column's b, q (rows t, t-1, t-2) and center terms (rows t, t-1)
  float gxu[C], gyu[C], b0[C], b1[C], b2[C], q0[C], q1[C], q2[C], c0[C],
      c1[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    gxu[c] = gyu[c] = b0[c] = b1[c] = b2[c] = 0.f;
    q0[c] = q1[c] = q2[c] = c0[c] = c1[c] = 0.f;
  }

  __syncthreads();   // the previous cell is done with the rings
  // prologue: rows s0-2 .. s0+STAGES-3 in flight, e of rows s0-2 .. s0
#pragma unroll
  for (int k = 0; k < STAGES; ++k) issue(s0 - 2 + k, k);
  cp_async_wait<STAGES - LEAD>();
  __syncthreads();
#pragma unroll
  for (int k = 0; k < LEAD; ++k)
    if (live) extrapolate(k, k);
  __syncthreads();

  // the prob window of the row to gather next, loaded a step ahead
  float pgv[C];
  auto load_pg = [&](int yy) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const Chan& ch = p.ch[c];
      pgv[c] = own_col && ch.pidx >= 0 && yy < s1
          ? scr_ld(win + ch.woff + ((yy - s0) >> ch.lsy) * (CW >> ch.lsx)
                       + (tid >> ch.lsx), p.resident)
          : 0.f;
    }
  };
  load_pg(s0);

  // step t: the terms of row t, then the gather of row t - 1 and e of row
  // t + LEAD.  Ring slot of row t: k; stage slot ks.  One barrier per step:
  // every ring holds one row more than a step reads.
  int k = 0, ks = 0;
  for (int t = s0 - 2; t <= s1; ++t) {
    issue(t + STAGES, ks);       // into the slot row t left
    const int y = t - 1;
    // ---- terms of row t
    if (live && term) {
      const float* et = e_s + k * C * EWID;
      const float* ed = e_s + ((k + 1) & 3) * C * EWID;
      float gx[C], gy[C];
      float gsq = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float e0 = et[c * EWID + ej];
        // forward differences (grad_step.py:96-97)
        gx[c] = xc < WT - 1 ? et[c * EWID + ej + 1] - e0 : 0.f;
        gy[c] = t < HT - 1 ? ed[c * EWID + ej] - e0 : 0.f;
        const float term2 = gx[c] * gx[c] + gy[c] * gy[c];
        gsq = c == 0 ? term2 : gsq + term2;
      }
      if (t >= s0 - 1) {
        const bool own = own_col && t >= s0 && t < s1;
        const float gn = sqrtf(gsq);
        const float inv = gn == 0.f ? 0.f : 1.f / gn;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          a_s[(k * C + c) * TC + tj] = gx[c] * inv;
          b2[c] = b1[c];
          b1[c] = b0[c];
          b0[c] = gy[c] * inv;
        }
        if (own) acc[C] += gn;
        if (TGV) {
          const bool yin = t >= 1 && t < HT;   // row in [1, h_true)
          float g_xx[C], sym[C], g_yy[C];
          float n2sq = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float e0 = et[c * EWID + ej];
            const float el = et[c * EWID + ej - 1];
            // the differences at x - 1 (row t) and, carried, at row t - 1
            const float gxl = xc - 1 < WT - 1 ? e0 - el : 0.f;
            const float gyl = t < HT - 1 ? ed[c * EWID + ej - 1] - el : 0.f;
            g_xx[c] = xc >= 1 ? gx[c] - gxl : 0.f;
            const float g_yx = (xc >= 1 && xc < WT) ? gy[c] - gyl : 0.f;
            const float g_xy = yin ? gx[c] - gxu[c] : 0.f;
            g_yy[c] = yin ? gy[c] - gyu[c] : 0.f;
            sym[c] = (g_xy + g_yx) * 0.5f;
            const float term2 = g_xx[c] * g_xx[c] + 2.f * sym[c] * sym[c]
                                + g_yy[c] * g_yy[c];
            n2sq = c == 0 ? term2 : n2sq + term2;
          }
          const float n2 = sqrtf(n2sq);
          const float inv2 = n2 == 0.f ? 0.f : 1.f / n2;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            c1[c] = c0[c];
            c0[c] = -(2.f * g_xx[c] + 2.f * sym[c] + 2.f * g_yy[c]) * inv2;
            p_s[(k * C + c) * TC + tj] = (g_xx[c] + sym[c]) * inv2;
            q2[c] = q1[c];
            q1[c] = q0[c];
            q0[c] = (g_yy[c] + sym[c]) * inv2;
            r_s[(k * C + c) * TC + tj] = -sym[c] * inv2;
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
    if (own_col && t >= s0 + 1) {
      const int x = xc;
      const int r_dn = k, r_up = (k + 2) & 3;  // r slots of rows y+1, y-1
      const bool in_true = y < HT && x < WT;
      const bool up = y >= 1 && y - 1 < HT, down = y + 1 < HT;
      const bool left = x >= 1, right = x + 1 < W;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float* ay = a_s + (ky * C + c) * TC;
        // TV: self -(a+b), from the left +a, from above +b (compute.c:98-104)
        const float a_l = left ? ay[tj - 1] : 0.f;
        const float b_u = up ? b2[c] : 0.f;
        float g = (-(ay[tj] + b1[c]) + a_l + b_u) * p.alpha;
        if (TGV) {
          const float* py = p_s + (ky * C + c) * TC;
          float g2 = c1[c];
          g2 = g2 + (right ? py[tj + 1] : 0.f);
          g2 = g2 + (left ? py[tj - 1] : 0.f);
          g2 = g2 + (down ? q0[c] : 0.f);
          g2 = g2 + (up ? q2[c] : 0.f);
          g2 = g2 + ((left && down) ? r_s[(r_dn * C + c) * TC + tj - 1] : 0.f);
          g2 = g2 + ((right && up) ? r_s[(r_up * C + c) * TC + tj + 1] : 0.f);
          g = g + p.alpha2 * g2;
        }
        if (!in_true) g = 0.f;   // padding stays frozen (iter_step.py:319-335)
        if (p.ch[c].pidx >= 0) g = g + pgv[c];
        gs[((size_t)c * p.RH + (y - s0)) * CW + tid] = narrow<LITE>(g);
        acc[c] += g * g;   // the f32 value, also in lite mode
      }
      load_pg(y + 1);
    }
    // ---- e of row t + LEAD, into the slot of row y (no thread reads it
    //      again: the terms of row t + 1 read rows t + 1 and t + 2)
    if (live && t + LEAD <= s1 + 1) extrapolate(ky, sl);
    k = (k + 1) & 3;
    ks = ks + 1 < STAGES ? ks + 1 : 0;
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

// ------------------------------------------------------------ projection

// The task of item i of a cell: channel c, block row r, coefficient
// column kx (lanes of one 8x8 block are 8 aligned lanes of one warp: every
// count is a multiple of 8).  `prob_only`: only the prob channels.
template <int C>
__device__ __forceinline__ bool task_of(const Params& p, const Cell& cell,
                                        int i, bool prob_only, int* c_out,
                                        int* r_out, int* kx_out) {
  int li = i;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const Chan& ch = p.ch[c];
    const int ncol = cell.cw >> ch.lsx;
    const int n = (prob_only && ch.pidx < 0)
                      ? 0
                      : ((cell.s1 - cell.s0) >> (3 + ch.lsy)) * ncol;
    if (li < n) {
      *c_out = c;
      *r_out = li / ncol;
      *kx_out = li - *r_out * ncol;
      return true;
    }
    li -= n;
  }
  *c_out = 0;
  *r_out = 0;
  *kx_out = 0;
  return false;
}

template <int C>
__device__ __forceinline__ int task_count(const Params& p, const Cell& cell,
                                          bool prob_only) {
  int n = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const Chan& ch = p.ch[c];
    if (!(prob_only && ch.pidx < 0))
      n += ((cell.s1 - cell.s0) >> (3 + ch.lsy)) * (cell.cw >> ch.lsx);
  }
  return n;
}

// 8 coefficients of a column -> rows of D^T X D at this lane's column:
// the row pass across the 8 lanes of the block (shuffles), the column pass
// in registers.  Dj[v] = D[v][lane & 7].
__device__ __forceinline__ void inverse8(const float (&x)[8],
                                         const float (&Dj)[8], float (&out)[8]) {
  float r[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < 8; ++v)
      s = __fmaf_rn(__shfl_sync(0xffffffffu, x[u], v, 8), Dj[v], s);
    r[u] = s;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) s = __fmaf_rn(c_D[u * 8 + i], r[u], s);
    out[i] = s;
  }
}

// The prob windows of a cell from the devq input: p_alpha * idct(devq).
template <int C, bool LITE>
__device__ void windows(const Params& p, const Cell& cell,
                        const float (&Dj)[8]) {
  using T = typename Side<LITE>::T;
  const int tid = threadIdx.x, lane = tid & 31;
  const int tot = task_count<C>(p, cell, true);
  float* win = (float*)(cell.scr + p.grad_bytes);
  for (int base = tid - lane; base < tot; base += NTH) {
    int c, r, kx;
    const bool act = task_of<C>(p, cell, base + lane, true, &c, &r, &kx);
    const Chan& ch = p.ch[c];
    const int cy0 = (cell.s0 >> ch.lsy) + 8 * r, cx = (cell.x0 >> ch.lsx) + kx;
    float x[8], v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      x[u] = act ? widen(((const T*)ch.devq)[((size_t)cell.b * ch.hc + cy0 + u)
                                             * ch.wc + cx])
                 : 0.f;
    inverse8(x, Dj, v);
    if (act) {
#pragma unroll
      for (int u = 0; u < 8; ++u)
        win[ch.woff + (8 * r + u) * (CW >> ch.lsx) + kx] = ch.pa * v[u];
    }
  }
}

// The band tiles of the projection (shared memory): the old f, the side
// values, the gradient rows (when the scratch is global) and fmid.
template <bool LITE>
struct Tiles {
  using T = typename Side<LITE>::T;
  float* f;             // [C][ay][CW] the old f
  T* side;              // side values
  const T* grad;        // the band's gradient rows, row stride CW
  int gstride;          // elements between channels of `grad`
  float* fm;            // fmid (f32 mode: in the side values' place)
};

// One coefficient column of one 8x8 block row of channel c (the task of
// this thread), footprint SY x SX (0: the channel's own at run time), from
// the band tiles: fmid = e - scale * grad once per pixel and the means,
// coefs = D m D^T (the column pass in registers, the row pass by shuffles
// across the block's 8 lanes), the box, devq and the distance, back = D^T
// clamp D and the prob window D^T devq D, then fnew = (fmid - mean) + back
// and the FISTA swap (fista = the old f; lite: d = bf16(fnew - f)) written
// straight to the canvas.  Every lane of the warp calls it (the shuffles):
// `act` is false past the tasks.
template <int C, bool LITE, int SY, int SX>
__device__ __forceinline__ void coef_task(
    const Params& p, const Cell& cell, const Tiles<LITE>& tl, int c, int r,
    int kx, bool act, int y0, float factor, float sc, const float (&Dv)[8],
    const float (&Dj)[8], float (&dacc)[MAXC]) {
  using T = typename Side<LITE>::T;
  const Chan& ch = p.ch[c];
  const int sy = SY ? SY : ch.sy, sx = SX ? SX : ch.sx;
  const int W = p.W, b = cell.b, s0 = cell.s0, x0 = cell.x0, ay = p.ay;
  const int cr0 = ((y0 - s0) >> ch.lsy) + 8 * r;   // cell coefficient row
  const size_t co0 = ((size_t)b * ch.hc + (s0 >> ch.lsy) + cr0) * ch.wc
                     + (x0 >> ch.lsx) + kx;
  float qv[8], dqv[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    qv[u] = act ? __ldg(ch.q + co0 + (size_t)u * ch.wc) : 0.f;
    dqv[u] = act ? (float)__ldg(ch.data + co0 + (size_t)u * ch.wc) : 0.f;
  }
  // fmid on the footprint (e once per pixel) and its means (1/(sy*sx) is
  // a power of two: exact)
  const float inv = 1.f / (float)(sy * sx);
  const int pr0 = 8 * r * sy, pc0 = kx * sx;       // band pixel row, column
  const int t0 = (c * ay + pr0) * CW + pc0;
  const T* gp = tl.grad + c * tl.gstride + pr0 * CW + pc0;
  float m[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    float sum = 0.f;
    if (act) {
#pragma unroll
      for (int i = 0; i < sy; ++i)
#pragma unroll
        for (int j = 0; j < sx; ++j) {
          const int k = (u * sy + i) * CW + j;
          const float fv = tl.f[t0 + k], sv = widen(tl.side[t0 + k]);
          const float e = LITE ? fv + factor * sv : fv + factor * (fv - sv);
          const float fm = e - sc * widen(gp[k]);
          sum += fm;
          tl.fm[t0 + k] = fm;
        }
    }
    m[u] = sum * inv;
  }
  // coefs = D m D^T
  float t[8], coef[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    float sacc = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) sacc = __fmaf_rn(c_D[u * 8 + i], m[i], sacc);
    t[u] = sacc;
  }
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    float sacc = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      sacc = __fmaf_rn(__shfl_sync(0xffffffffu, t[u], j, 8), Dv[j], sacc);
    coef[u] = sacc;
  }
  // the box, the projection, the prob carry
  float cl[8], dd[8];
  float dist = 0.f;
  const bool prob = ch.pidx >= 0 && act;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const float q = qv[u], dq = dqv[u] * q;
    cl[u] = act ? fminf(fmaxf(coef[u], dq - 0.5f * q), dq + 0.5f * q) : 0.f;
    const float iq = (q > 0.f && q < FREE_Q) ? 1.f / q : 0.f;
    const float devp = (cl[u] - dq) * iq;
    const T st = narrow<LITE>(devp * iq);
    dd[u] = prob ? widen(st) : 0.f;             // the stored value
    if (prob) {
      dist += devp * devp;
      ((T*)ch.devq)[co0 + (size_t)u * ch.wc] = st;
    }
  }
#pragma unroll
  for (int j = 0; j < MAXC; ++j)
    if (j == ch.pidx && act) dacc[j] += dist;
  float back[8], pback[8];
  inverse8(cl, Dj, back);
  inverse8(dd, Dj, pback);
  // fnew and the FISTA swap, straight to the canvas; the window
  if (act) {
    const size_t o0 = ((size_t)b * C + c) * p.H * (size_t)W
                      + (size_t)(y0 + pr0) * W + x0 + pc0;
    float* fg = p.f + o0;
    T* sg = (T*)p.side + o0;
    float* win = (float*)(cell.scr + p.grad_bytes);
    const int bw = CW >> ch.lsx;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int i = 0; i < sy; ++i)
#pragma unroll
        for (int j = 0; j < sx; ++j) {
          const int k = (u * sy + i) * CW + j;
          const size_t og = (size_t)(u * sy + i) * W + j;
          const float fn = (tl.fm[t0 + k] - m[u]) + back[u];
          const float fv = tl.f[t0 + k];
          sg[og] = narrow<LITE>(LITE ? fn - fv : fv);
          fg[og] = fn;
        }
      if (ch.pidx >= 0)
        win[ch.woff + (cr0 + u) * bw + kx] = ch.pa * pback[u];
    }
  }
}

// The cell's projection and FISTA swap, one band of p.ay = 8 * max(sy)
// rows at a time (whole coefficient block rows of every channel):
//   A. 16-byte cp.async copies of the band's f and side rows (and its
//      gradient rows when the scratch is global) into shared tiles: every
//      load of the band in flight at once, one wait;
//   B. coef_task per coefficient column of a block row, from shared memory.
//      Each channel's tasks are padded to whole warps, so a warp's lanes
//      share one channel and footprint (the loops over it unroll), and the
//      channels go largest footprint first (the last, partial round then
//      holds the cheapest tasks).
// Two block barriers a band.  Distance terms into dacc[prob index].
template <int C, bool LITE>
__device__ __forceinline__ void project(const Params& p, const Cell& cell,
                                        float factor, const float* scale_s,
                                        unsigned char* smem, const float* Ds,
                                        float (&dacc)[MAXC]) {
  using T = typename Side<LITE>::T;
  constexpr int EPC = 16 / (int)sizeof(T);      // side elements a chunk
  const int tid = threadIdx.x, lane = tid & 31;
  const int W = p.W, b = cell.b, s0 = cell.s0, x0 = cell.x0, ay = p.ay;
  const int cw = cell.cw;
  const size_t HW = (size_t)p.H * W;
  const int TP = C * ay * CW;                    // elements of a tile
  Tiles<LITE> tl;
  tl.f = (float*)smem;
  tl.side = (T*)(tl.f + TP);
  T* tG = tl.side + TP;
  tl.fm = LITE ? (float*)(tG + TP) : (float*)tl.side;
  // the band's gradient rows: the scratch itself when it is resident
  tl.gstride = p.resident ? p.RH * CW : ay * CW;
  float Dv[8], Dj[8];                            // D[v][j], v or j = lane & 7
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    Dv[j] = Ds[(lane & 7) * 9 + j];
    Dj[j] = Ds[j * 9 + (lane & 7)];
  }
  // tasks per channel, padded to whole warps; channels in reverse order
  int tpad[C], tot = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int n = (ay >> (3 + p.ch[c].lsy)) * (cw >> p.ch[c].lsx);
    tpad[c] = (n + 31) & ~31;
    tot += tpad[c];
  }

  for (int y0 = s0; y0 < cell.s1; y0 += ay) {
    tl.grad = p.resident ? (const T*)cell.scr + (y0 - s0) * CW : tG;
    // ---- A: the band into the tiles
    {
      const int fch = cw / 4, sch = cw / EPC;
      for (int i = tid; i < C * ay * fch; i += NTH) {
        const int row = i / fch, q = i - row * fch;       // row = c ay + yy
        const int c = row / ay, yy = row - c * ay;
        cp_async16(tl.f + row * CW + 4 * q,
                   p.f + ((size_t)b * C + c) * HW + (size_t)(y0 + yy) * W
                       + x0 + 4 * q, 16);
      }
      for (int i = tid; i < C * ay * sch; i += NTH) {
        const int row = i / sch, q = i - row * sch;
        const int c = row / ay, yy = row - c * ay;
        cp_async16(tl.side + row * CW + EPC * q,
                   (const T*)p.side + ((size_t)b * C + c) * HW
                       + (size_t)(y0 + yy) * W + x0 + EPC * q, 16);
      }
      if (!p.resident) {
        const int gch = CW / EPC;                          // whole rows
        for (int i = tid; i < C * ay * gch; i += NTH) {
          const int row = i / gch, q = i - row * gch;
          const int c = row / ay, yy = row - c * ay;
          cp_async16(tG + row * CW + EPC * q,
                     (const T*)cell.scr
                         + ((size_t)c * p.RH + (y0 - s0) + yy) * CW + EPC * q,
                     16);
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();

    // ---- B: the coefficient tasks, a warp's lanes on one channel
    for (int base = tid - lane; base < tot; base += NTH) {
      int li = base, c = C - 1;
#pragma unroll
      for (int cc = C - 1; cc > 0; --cc)
        if (c == cc && li >= tpad[cc]) {
          li -= tpad[cc];
          --c;
        }
      const Chan& ch = p.ch[c];
      li += lane;
      const int ncol = cw >> ch.lsx;
      const bool act = li < (ay >> (3 + ch.lsy)) * ncol;
      const int r = act ? li / ncol : 0, kx = act ? li - r * ncol : 0;
      const float sc = scale_s[b * C + c];
      switch (ch.sy * 8 + ch.sx) {           // warp-uniform
        case 9:
          coef_task<C, LITE, 1, 1>(p, cell, tl, c, r, kx, act, y0, factor, sc,
                                   Dv, Dj, dacc);
          break;
        case 18:
          coef_task<C, LITE, 2, 2>(p, cell, tl, c, r, kx, act, y0, factor, sc,
                                   Dv, Dj, dacc);
          break;
        case 10:
          coef_task<C, LITE, 1, 2>(p, cell, tl, c, r, kx, act, y0, factor, sc,
                                   Dv, Dj, dacc);
          break;
        case 17:
          coef_task<C, LITE, 2, 1>(p, cell, tl, c, r, kx, act, y0, factor, sc,
                                   Dv, Dj, dacc);
          break;
        default:
          coef_task<C, LITE, 0, 0>(p, cell, tl, c, r, kx, act, y0, factor, sc,
                                   Dv, Dj, dacc);
          break;
      }
    }
    __syncthreads();   // the tiles are free for the next band
  }
}

// ---------------------------------------------------------------- the solve

template <int C, bool TGV, bool LITE>
__global__ void __launch_bounds__(NTH, MIN_BLOCKS) solve_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[NW * (MAXC + 2)];
  __shared__ float scale_s[MAXB * MAXC];
  __shared__ float Ds[8 * 9];           // D, rows padded to 9 floats
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = blockIdx.x, G = p.G;
  const int n0 = g * p.k, n1 = min(p.ncell, n0 + p.k);
  const int cpi = p.strips * p.segs;
  const int b_lo = n0 / cpi, b_hi = (n1 - 1) / cpi;
  const int Pd = p.P > 0 ? p.P : 1;
  unsigned char* scr = p.resident
      ? smem + p.phase_bytes
      : p.scratch + (size_t)g * p.k * p.cell_bytes;
  if (tid < 64) Ds[(tid >> 3) * 9 + (tid & 7)] = c_D[tid];
  __syncthreads();
  float Dj[8];                          // D[v][lane & 7], the windows
#pragma unroll
  for (int j = 0; j < 8; ++j) Dj[j] = Ds[j * 9 + (lane & 7)];

  // prologue: the prob windows from the devq input
  if (p.P > 0)
    for (int n = n0; n < n1; ++n) {
      const Cell cell = cell_at(p, n, scr + (size_t)(n - n0) * p.cell_bytes);
      if (cell.live) windows<C, LITE>(p, cell, Dj);
    }
  __syncthreads();

  for (int it = 0; it < p.nsteps; ++it) {
    const float factor = p.factors[it];

    // ---- gradient phase: the block's cells come in image order
    {
      float acc[C + 2];
#pragma unroll
      for (int j = 0; j < C + 2; ++j) acc[j] = 0.f;
      for (int n = n0; n < n1; ++n) {
        const Cell cell = cell_at(p, n, scr + (size_t)(n - n0) * p.cell_bytes);
        if (cell.live) march<C, TGV, LITE>(p, cell, factor, smem, acc);
        if (n + 1 == n1 || (n + 1) / cpi != cell.b) {
          block_sum<C + 2>(acc, red,
                           p.gpart + ((size_t)cell.b * G + g) * (C + 2),
                           C + 2);
#pragma unroll
          for (int j = 0; j < C + 2; ++j) acc[j] = 0.f;
        }
      }
    }
    grid.sync();

    // ---- norms of the block's images: their blocks' rows of sums, read
    //      once and contiguously into shared memory (the phase region is
    //      free here), then one fixed-order sum per column (every block the
    //      same order); the previous iteration's distances, spread over the
    //      blocks
    {
      float* rows_s = (float*)smem;
      for (int b = b_lo; b <= b_hi; ++b) {
        const int r0 = first_block(p, b), nr = last_block(p, b) - r0 + 1;
        const float* src = p.gpart + ((size_t)b * G + r0) * (C + 2);
        for (int i = tid; i < nr * (C + 2); i += NTH) rows_s[i] = __ldcg(src + i);
        __syncthreads();
        for (int j = warp; j < C + 2; j += NW) {
          float sum = 0.f;
          for (int i = lane; i < nr; i += 32) sum += rows_s[i * (C + 2) + j];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            sum += __shfl_down_sync(0xffffffffu, sum, o);
          if (lane == 0) {
            if (j < C) {
              const float n = sqrtf(sum);
              scale_s[b * C + j] = n == 0.f ? 0.f : p.steps[b] / n;
            }
            if (g == r0) {
              const float val = j < C ? sum : (j == C ? p.alpha * sum
                                               : (TGV ? p.alpha2 * sum : 0.f));
              p.out[((size_t)b * p.nsteps + it) * NCOL + j] = val;
            }
          }
        }
        __syncthreads();
      }
      const int ncols = it > 0 ? p.B * p.P : 0;
      const float* dprev = p.dpart + (size_t)((it - 1) & 1) * p.B * G * Pd;
      for (int col = g + warp * G; col < ncols; col += NW * G) {
        const int b = col / p.P, j = col % p.P;
        const float sum = warp_column_sum(dprev + (size_t)b * G * Pd,
                                          first_block(p, b), last_block(p, b),
                                          Pd, j);
        if (lane == 0)
          p.out[((size_t)b * p.nsteps + it - 1) * NCOL + C + 2 + j] =
              0.5f * sum;
      }
    }
    __syncthreads();

    // ---- projection phase
    {
      float dacc[MAXC];
#pragma unroll
      for (int j = 0; j < MAXC; ++j) dacc[j] = 0.f;
      float* dcur = p.dpart + (size_t)(it & 1) * p.B * G * Pd;
      for (int n = n0; n < n1; ++n) {
        const Cell cell = cell_at(p, n, scr + (size_t)(n - n0) * p.cell_bytes);
        if (cell.live) project<C, LITE>(p, cell, factor, scale_s, smem, Ds, dacc);
        if (p.P > 0 && (n + 1 == n1 || (n + 1) / cpi != cell.b)) {
          block_sum<MAXC>(dacc, red, dcur + ((size_t)cell.b * G + g) * Pd,
                          p.P);
#pragma unroll
          for (int j = 0; j < MAXC; ++j) dacc[j] = 0.f;
        }
      }
    }
    grid.sync();
  }

  // the last iteration's distances
  if (p.nsteps > 0) {
    const int it = p.nsteps - 1, ncols = p.B * p.P;
    const float* dlast = p.dpart + (size_t)(it & 1) * p.B * G * Pd;
    for (int col = g + warp * G; col < ncols; col += NW * G) {
      const int b = col / p.P, j = col % p.P;
      const float sum = warp_column_sum(dlast + (size_t)b * G * Pd,
                                        first_block(p, b), last_block(p, b),
                                        Pd, j);
      if (lane == 0)
        p.out[((size_t)b * p.nsteps + it) * NCOL + C + 2 + j] = 0.5f * sum;
    }
  }
}

// ---------------------------------------------------------------- host side

template <int C, bool TGV, bool LITE>
int ring_bytes() {
  return Ring<C, TGV, LITE>::BYTES;
}

template <int C, bool TGV, bool LITE>
cudaError_t occupancy(int bytes, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      solve_kernel<C, TGV, LITE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, solve_kernel<C, TGV, LITE>, NTH, bytes);
}

template <int C, bool TGV, bool LITE>
cudaError_t launch(Params& p, cudaStream_t stream) {
  const int bytes = p.phase_bytes + (p.resident ? p.cell_bytes * p.k : 0);
  cudaError_t err = cudaFuncSetAttribute(
      solve_kernel<C, TGV, LITE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((void*)solve_kernel<C, TGV, LITE>,
                                    dim3(p.G), dim3(NTH), args, bytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the instantiations, indexed ((C - 1) * 2 + tgv) * 2 + lite
using RingFn = int (*)();
using OccFn = cudaError_t (*)(int, int*);
using LaunchFn = cudaError_t (*)(Params&, cudaStream_t);
#define J2P_VARIANTS(F)                                                     \
  {F<1, false, false>, F<1, false, true>, F<1, true, false>, F<1, true, true>, \
   F<2, false, false>, F<2, false, true>, F<2, true, false>, F<2, true, true>, \
   F<3, false, false>, F<3, false, true>, F<3, true, false>, F<3, true, true>, \
   F<4, false, false>, F<4, false, true>, F<4, true, false>, F<4, true, true>}
const RingFn kRing[4 * MAXC] = J2P_VARIANTS(ring_bytes);
const OccFn kOcc[4 * MAXC] = J2P_VARIANTS(occupancy);
const LaunchFn kLaunch[4 * MAXC] = J2P_VARIANTS(launch);
#undef J2P_VARIANTS

int variant(int C, int tgv, int lite) {
  return ((C - 1) * 2 + (tgv ? 1 : 0)) * 2 + (lite ? 1 : 0);
}

int log2i(int v) { return v == 1 ? 0 : (v == 2 ? 1 : 2); }

// Checks the per-channel ints (sy, sx, prob index) and fills the channel
// geometry of p (no pointers); returns cudaErrorInvalidValue on a bad one.
cudaError_t channels(Params& p, const int* ints) {
  int P = 0;
  for (int c = 0; c < p.C; ++c) {
    Chan& ch = p.ch[c];
    ch.sy = ints[3 * c];
    ch.sx = ints[3 * c + 1];
    ch.pidx = ints[3 * c + 2];
    if ((ch.sy != 1 && ch.sy != 2 && ch.sy != 4) ||
        (ch.sx != 1 && ch.sx != 2 && ch.sx != 4) || p.H % (8 * ch.sy) ||
        p.W % (8 * ch.sx) || ch.pidx >= p.C || (ch.pidx >= 0 && ch.pidx != P))
      return cudaErrorInvalidValue;
    P += ch.pidx >= 0;
    ch.lsy = log2i(ch.sy);
    ch.lsx = log2i(ch.sx);
    ch.hc = p.H / ch.sy;
    ch.wc = p.W / ch.sx;
  }
  p.P = P;
  return cudaSuccess;
}

// The launch's decomposition (see the header): cells, their rows, the grid,
// whether the scratch is resident, the shared memory and scratch bytes.
// kernels/iter_step.py::plan mirrors it.
cudaError_t make_plan(Params& p, int tgv, int lite, long long* scratch_bytes) {
  const int v = variant(p.C, tgv, lite);
  int ay = 8;
  for (int c = 0; c < p.C; ++c) ay = max(ay, 8 * p.ch[c].sy);
  p.ay = ay;
  p.phase_bytes = max(kRing[v](), proj_bytes(p.C, ay));
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = kOcc[v](p.phase_bytes, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int slots = per_sm * sms;
  p.strips = (p.W + CW - 1) / CW;
  const int target = max(1, slots / (p.B * p.strips));
  int rh = max(MIN_RH, (p.H + target - 1) / target);
  rh = (rh + ay - 1) / ay * ay;
  p.RH = rh;
  p.segs = (p.H + rh - 1) / rh;
  p.ncell = p.B * p.strips * p.segs;
  const int side = lite ? 2 : 4;
  const int grad = p.C * rh * CW * side;
  int wfl = 0;
  for (int c = 0; c < p.C; ++c) {
    p.ch[c].woff = wfl;
    if (p.ch[c].pidx >= 0) wfl += (rh / p.ch[c].sy) * (CW / p.ch[c].sx);
  }
  const int cell = grad + 4 * wfl;
  p.grad_bytes = grad;
  p.cell_bytes = cell;
  p.resident = 0;
  p.k = (p.ncell + slots - 1) / slots;
  if (ALLOW_RESIDENT && p.phase_bytes + cell <= MAX_SMEM) {
    int per_sm1 = 0;
    err = kOcc[v](p.phase_bytes + cell, &per_sm1);
    if (err != cudaSuccess) return err;
    if (per_sm1 * sms >= p.ncell) {
      p.resident = 1;
      p.k = 1;
    }
  }
  p.G = (p.ncell + p.k - 1) / p.k;
  *scratch_bytes = p.resident ? 0 : (long long)p.G * p.k * cell;
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* j2p_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Co-resident blocks per SM of the (C, tgv, lite) kernel with `bytes` of
// dynamic shared memory, or -(the CUDA error).
int j2p_fused_solve_occupancy(int C, int tgv, int lite, int bytes) {
  if (C < 1 || C > MAXC) return -(int)cudaErrorInvalidValue;
  int per_sm = 0;
  const cudaError_t err = kOcc[variant(C, tgv, lite)](bytes, &per_sm);
  return err == cudaSuccess ? per_sm : -(int)err;
}

// Shared memory bytes of the gradient phase's rings for (C, tgv, lite).
int j2p_fused_solve_ring_bytes(int C, int tgv, int lite) {
  if (C < 1 || C > MAXC) return -(int)cudaErrorInvalidValue;
  return kRing[variant(C, tgv, lite)]();
}

// The decomposition of a launch on the current device: out[0..7] = grid
// blocks G, cells per block k, rows per cell RH, resident (0/1), scratch
// bytes (the global array, 0 when resident), cells, phase bytes, cell
// bytes.  ints as j2p_fused_solve's.  Returns the first CUDA error, else 0.
int j2p_fused_solve_plan(int B, int C, int H, int W, const int* ints,
                         int tgv, int lite, long long* out) {
  if (C < 1 || C > MAXC || B < 1 || B > MAXB) return (int)cudaErrorInvalidValue;
  Params p;
  p.B = B;
  p.C = C;
  p.H = H;
  p.W = W;
  cudaError_t err = channels(p, ints);
  if (err != cudaSuccess) return (int)err;
  long long scratch = 0;
  err = make_plan(p, tgv, lite, &scratch);
  if (err != cudaSuccess) return (int)err;
  const long long vals[8] = {p.G, p.k, p.RH, p.resident, scratch,
                             p.ncell, p.phase_bytes, p.cell_bytes};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return 0;
}

// f: [B, C, H, W] f32; side: [B, C, H, W] f32 fista, or bf16 d = f - fista
// with lite; scratch: j2p_fused_solve_plan's scratch bytes (null when 0);
// factors [nsteps]; ext [B, 2] int32; steps [B]; out [B, nsteps, 8] (zeroed
// by the caller); gpart [B, G, C + 2]; dpart [2, B, G, max(P, 1)].
// ptrs[3c..3c+2]: data (int16), q (f32), devq (f32, lite: bf16) of channel
// c ([B, H/sy, W/sx]); ints[3c..3c+2]: sy, sx, prob index (-1: off, else
// 0, 1, ... in channel order); pa[c]: p_alpha.  G: the plan's grid (a
// check).  The padding of a dynamic-extent image (beyond its extent) must
// hold a zero state, as the serving runner makes it.  Returns the first
// CUDA error, else 0.
int j2p_fused_solve(float* f, void* side, void* scratch, const float* factors,
                    const int* ext, const float* steps, float* out,
                    float* gpart, float* dpart, const uint64_t* ptrs,
                    const int* ints, const float* pa, int B, int C, int H,
                    int W, int nsteps, int G, float alpha, float alpha2,
                    int tgv, int lite, void* stream) {
  if (C < 1 || C > MAXC || B < 1 || B > MAXB || nsteps < 0 || H < 8 || W < 8)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.f = f;
  p.side = side;
  p.scratch = (unsigned char*)scratch;
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
  cudaError_t err = channels(p, ints);
  if (err != cudaSuccess) return (int)err;
  for (int c = 0; c < C; ++c) {
    Chan& ch = p.ch[c];
    ch.data = (const int16_t*)ptrs[3 * c];
    ch.q = (const float*)ptrs[3 * c + 1];
    ch.devq = ch.pidx >= 0 ? (void*)ptrs[3 * c + 2] : nullptr;
    ch.pa = pa[c];
  }
  long long scratch_bytes = 0;
  err = make_plan(p, tgv, lite, &scratch_bytes);
  if (err != cudaSuccess) return (int)err;
  if (G != p.G || (scratch_bytes > 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (nsteps == 0) return 0;
  return (int)kLaunch[variant(C, tgv, lite)](p, (cudaStream_t)stream);
}

}  // extern "C"
