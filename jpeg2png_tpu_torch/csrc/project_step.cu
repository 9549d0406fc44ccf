// K2 and K6: fused normalized step + box projection + prob gradient, for
// Hopper.
//
// K2 replaces the Pallas kernel
// jpeg2png_tpu/kernels/project_step.py::fused_project_multi
// (_kernel_multi, _stripe_math); K6 replaces
// jpeg2png_tpu/kernels/project_step.py::fused_project (_kernel,
// _kernel_adapter), the same function for one channel.  For every channel c
// of a [C, H, W] f32 canvas (K6: C = 1), with footprint (sy, sx) and
// coefficient rasters [H/sy, W/sx] (reference: compute.c:209-216, 334-404,
// 38-70):
//
//   fmid  = e - scale[c] * g
//   m     = footprint mean of fmid            (8 x 8 per coefficient block)
//   coefs = D m D^T                           (orthonormal 8x8 DCT-II)
//   clamp = clip(coefs, lo, hi)
//   fnew  = (fmid - upsample(m)) + upsample(D^T clamp D)
//   devp  = (clamp - dq) * iq,  dist[c] = 0.5 * sum devp^2
//   pgrad = p_alpha * upsample(D^T (devp * iq) D)
//
// fnew is the reference's mean/residual reconstruction (compute.c:349-403,
// ops/projection.py), which equals the TPU kernel's correction form
// fmid + ss * P_r^T (clamp - coefs) P_c up to rounding.  The rounding is
// not neutral: the reconstruction leaves round-off in flat regions where
// the correction form keeps them exactly flat, and the TV subgradient
// (1/|g| at |g| ~ 0) turns that into different trajectories.  This form
// tracks the reference binary's CSV logs as the JAX package's XLA path
// does.  pgrad equals the TPU kernel's pa_ss * P_r^T (devp * iq) P_c.
//
// Bound on an H100: device memory.  Per pixel it reads e, g and writes
// fnew (+ pgrad) for every channel, and per coefficient reads lo, hi, dq,
// iq, against three 8x8 transform pairs per coefficient block.
// Design: each (8*sy x 8*sx) pixel footprint maps to exactly one 8x8
// coefficient block and depends on nothing else.  A block of 256 threads
// takes four horizontally neighbouring coefficient blocks of one channel,
// one thread per coefficient (u, v): warp u reads pixel rows of all four
// blocks, so loads are contiguous across the warp.  The transforms run
// through shared memory; every input is read from device memory once
// (the footprint's second read, for the residual, hits the caches) and
// every output written once.  The DCT matrix lives in
// __constant__ memory and is staged to shared memory per block (threads of
// a warp index it by different rows).  Precision: plain f32 with fused
// multiply-adds; the TPU kernel's bf16x3 matrix-unit split is not needed.
// Distances: one partial per block, reduced per channel in a fixed order
// by a second kernel (no float atomics).  K6 runs the same device
// functions (project_blocks, block_partial) on one channel with no
// per-channel table and, for footprints of 1 or 2 pixels per axis, the
// footprint as a compile-time constant: the row-striped solve's one-channel
// bands (-s with --tpu-stripes, grayscale) take it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads: 8 coefficient rows x 4 blocks x 8 columns
constexpr int KB = 4;     // coefficient blocks per thread block
constexpr int MAXC = 4;
constexpr int MAXS = 4;   // largest footprint per axis (libjpeg's limit)

// orthonormal 8-point DCT-II matrix D[k][n] = s_k cos(pi (2n+1) k / 16),
// the float64 values rounded to f32 (ops/dct.py dct_matrix_f64)
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
  const float* lo;
  const float* hi;
  const float* dq;      // null when the prob term is off
  const float* iq;
  float* pgrad;         // [H, W] plane of the pgrad output, or null
  float pa;             // p_alpha (= pa_ss / (sy * sx))
  int sy, sx;
  int nbx;              // coefficient blocks per row
  int nbx4;             // thread blocks per coefficient-block row
  int block0;           // first thread block of this channel
};

struct Params {
  const float* e;
  const float* g;
  const float* scales;  // [C] step_size / |grad_c| on the device
  float* fnew;
  float* part;          // [nblocks] distance partials
  int C, H, W;
  Chan ch[MAXC];
};

struct Smem {
  // 8x8 tiles padded to 9 columns: lanes of one warp that read column j
  // of the four blocks then hit four different banks
  float D[64];
  float A[KB][8][9];   // footprint means, then clamped coefs
  float T[KB][8][9];   // transform intermediate
  float B[KB][8][9];   // devp * iq
  float T2[KB][8][9];
  float red[NT / 32];
};

// The DCT matrix from __constant__ memory to shared memory (threads of a
// warp index it by different rows).
__device__ __forceinline__ void stage_dct(Smem& s) {
  if (threadIdx.x < 64) s.D[threadIdx.x] = c_D[threadIdx.x];
}

// One thread block's share of a channel: four horizontally neighbouring
// coefficient blocks of row cby, one thread per coefficient.  e, g, fnew:
// the channel's [H, W] planes.  SY, SX: the footprint, or 0 for the
// channel's own ch.sy, ch.sx at run time.  Returns the thread's term of the
// prob distance (0 when the prob term is off).
template <int SY, int SX>
__device__ __forceinline__ float project_blocks(
    const Chan ch, const float* e, const float* g, float* fnew, float scale,
    int W, int local, Smem& sm) {
  const int tid = threadIdx.x;
  const int cby = local / ch.nbx4;
  const int bx = (local % ch.nbx4) * KB + (tid & 31) / 8;
  const int u = tid >> 5, v = tid & 7, kb = (tid & 31) >> 3;
  const bool active = bx < ch.nbx;
  const int sy = SY ? SY : ch.sy, sx = SX ? SX : ch.sx;
  const bool prob = ch.dq != nullptr;
  const float* D = sm.D;

  // 1. normalized step on this coefficient's footprint, summed for its
  //    mean.  Step 5 reads the footprint again (from L1/L2) instead of
  //    holding up to 16 values in registers for the whole block: fewer
  //    registers, more resident blocks to hide memory latency.
  const int py0 = cby * 8 * sy + u * sy, px0 = bx * 8 * sx + v * sx;
  float sum = 0.f;
  if (active) {
    for (int i = 0; i < sy; ++i)
      for (int j = 0; j < sx; ++j) {
        const size_t o = (size_t)(py0 + i) * W + (px0 + j);
        sum += e[o] - scale * g[o];
      }
  }
  // 1/(sy*sx) is a power of two: the product is the exact quotient
  const float mean = sum * (1.f / (float)(sy * sx));
  sm.A[kb][u][v] = mean;
  __syncthreads();

  // 2. coefs = D m D^T
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += sm.A[kb][u][j] * D[v * 8 + j];
  sm.T[kb][u][v] = s;
  __syncthreads();
  float coef = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) coef += D[u * 8 + i] * sm.T[kb][i][v];

  // 3. box projection and prob deviation at coefficient (8 cby + u, 8 bx + v)
  const int wc = W / sx;
  const size_t co = (size_t)(cby * 8 + u) * wc + (bx * 8 + v);
  float cl = 0.f, dd = 0.f, dist = 0.f;
  if (active) {
    cl = fminf(fmaxf(coef, ch.lo[co]), ch.hi[co]);
    if (prob) {
      const float iq = ch.iq[co];
      const float devp = (cl - ch.dq[co]) * iq;
      dist = devp * devp;
      dd = devp * iq;
    }
  }
  __syncthreads();   // every thread has read T before A / T are rewritten
  sm.A[kb][u][v] = cl;
  sm.B[kb][u][v] = dd;
  __syncthreads();

  // 4. back = D^T clamp D (and D^T dd D for the prob gradient)
  s = 0.f;
  float s2 = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    s += sm.A[kb][u][k] * D[k * 8 + v];
    s2 += sm.B[kb][u][k] * D[k * 8 + v];
  }
  sm.T[kb][u][v] = s;
  sm.T2[kb][u][v] = s2;
  __syncthreads();
  float back = 0.f, pback = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    back += D[k * 8 + u] * sm.T[kb][k][v];
    pback += D[k * 8 + u] * sm.T2[kb][k][v];
  }

  // 5. write the footprint: fnew (and pgrad) once per pixel, in the
  //    reconstruction form (fmid - mean) + back
  if (active) {
    const float pg = ch.pa * pback;
    for (int i = 0; i < sy; ++i)
      for (int j = 0; j < sx; ++j) {
        const size_t o = (size_t)(py0 + i) * W + (px0 + j);
        const float fm = e[o] - scale * g[o];
        fnew[o] = (fm - mean) + back;
        if (ch.pgrad) ch.pgrad[o] = pg;
      }
  }
  return dist;
}

// This block's distance partial, fixed-order reduction.
__device__ __forceinline__ void block_partial(float dist, Smem& sm, float* out) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) dist += __shfl_down_sync(0xffffffffu, dist, o);
  if ((tid & 31) == 0) sm.red[tid >> 5] = dist;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int w = 0; w < NT / 32; ++w) t += sm.red[w];
    *out = t;
  }
}

// K2: every channel of the canvas, one launch.
__global__ void __launch_bounds__(NT) project_kernel(Params p) {
  __shared__ Smem sm;
  stage_dct(sm);
  int c = 0;
  while (c + 1 < p.C && (int)blockIdx.x >= p.ch[c + 1].block0) ++c;
  const size_t HW = (size_t)p.H * p.W;
  const float dist = project_blocks<0, 0>(
      p.ch[c], p.e + c * HW, p.g + c * HW, p.fnew + c * HW, p.scales[c], p.W,
      blockIdx.x - p.ch[c].block0, sm);
  block_partial(dist, sm, p.part + blockIdx.x);
}

// K6: one channel, its footprint fixed at compile time.
struct OneParams {
  const float* e;
  const float* g;
  const float* scale;   // [1] step_size / |grad| on the device
  float* fnew;
  float* part;
  int W;
  Chan ch;
};

template <int SY, int SX>
__global__ void __launch_bounds__(NT) project_one_kernel(OneParams p) {
  __shared__ Smem sm;
  stage_dct(sm);
  const float dist = project_blocks<SY, SX>(p.ch, p.e, p.g, p.fnew,
                                            *p.scale, p.W, blockIdx.x, sm);
  block_partial(dist, sm, p.part + blockIdx.x);
}

struct Ranges {
  int start[MAXC + 1];
  int prob[MAXC];
};

// dists[c] = 0.5 * sum of channel c's block partials, fixed order
__global__ void __launch_bounds__(NT)
reduce_dists(const float* part, Ranges r, float* dists) {
  __shared__ float red[NT];
  const int c = blockIdx.x;
  float s = 0.f;
  for (int b = r.start[c] + threadIdx.x; b < r.start[c + 1]; b += NT) s += part[b];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = NT / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) dists[c] = r.prob[c] ? 0.5f * red[0] : 0.f;
}

template <int SY, int SX>
cudaError_t launch_one(const OneParams& p, int nblocks, cudaStream_t s) {
  project_one_kernel<SY, SX><<<nblocks, NT, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* j2p_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// e, g, fnew: [C, H, W]; pgrad: [P, H, W]; scales: [C] (device).
// ptrs[4c..4c+3]: lo, hi, dq, iq of channel c ([H/sy, W/sx], dq = iq = 0
// when its prob term is off); ints[3c..3c+2]: sy, sx, pgrad plane (-1: off);
// pa[c]: p_alpha.  part: [sum_c (H / (8 sy)) * ceil(W / (8 sx) / 4)].
// Returns the first cudaGetLastError() that is not cudaSuccess, else 0.
int j2p_fused_project_multi(const float* e, const float* g,
                            const float* scales, float* fnew, float* pgrad,
                            float* part, float* dists,
                            const uint64_t* ptrs, const int* ints,
                            const float* pa, int C, int H, int W,
                            void* stream) {
  if (C < 1 || C > MAXC) return (int)cudaErrorInvalidValue;
  Params p;
  p.e = e;
  p.g = g;
  p.scales = scales;
  p.fnew = fnew;
  p.part = part;
  p.C = C;
  p.H = H;
  p.W = W;
  Ranges r;
  int nblocks = 0;
  for (int c = 0; c < C; ++c) {
    Chan& ch = p.ch[c];
    ch.lo = (const float*)ptrs[4 * c];
    ch.hi = (const float*)ptrs[4 * c + 1];
    const int pidx = ints[3 * c + 2];
    ch.dq = pidx >= 0 ? (const float*)ptrs[4 * c + 2] : nullptr;
    ch.iq = pidx >= 0 ? (const float*)ptrs[4 * c + 3] : nullptr;
    ch.pgrad = pidx >= 0 ? pgrad + (size_t)pidx * H * W : nullptr;
    ch.pa = pa[c];
    ch.sy = ints[3 * c];
    ch.sx = ints[3 * c + 1];
    if (ch.sy < 1 || ch.sy > MAXS || ch.sx < 1 || ch.sx > MAXS ||
        H % (8 * ch.sy) || W % (8 * ch.sx))
      return (int)cudaErrorInvalidValue;
    ch.nbx = W / (8 * ch.sx);
    ch.nbx4 = (ch.nbx + KB - 1) / KB;
    ch.block0 = nblocks;
    r.start[c] = nblocks;
    r.prob[c] = pidx >= 0;
    nblocks += (H / (8 * ch.sy)) * ch.nbx4;
  }
  r.start[C] = nblocks;
  cudaStream_t s = (cudaStream_t)stream;
  project_kernel<<<nblocks, NT, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_dists<<<C, NT, 0, s>>>(part, r, dists);
  return (int)cudaGetLastError();
}

// K6: one channel.  e, g, fnew, pgrad: [H, W] (pgrad null when the prob term
// is off); lo, hi, dq, iq: [H/sy, W/sx] (dq, iq null when it is off);
// scale: [1] on the device; pa: p_alpha.  part: [(H / (8 sy)) *
// ceil(W / (8 sx) / 4)] scratch; dist: [1] = 0.5 * sum devp^2 (0 when the
// prob term is off).  Footprints (1|2) x (1|2) run a kernel specialised for
// them, the others (up to 4 x 4) K2's run-time form.
int j2p_fused_project(const float* e, const float* g, const float* scale,
                      float* fnew, float* pgrad, float* part, float* dist,
                      const float* lo, const float* hi, const float* dq,
                      const float* iq, float pa, int sy, int sx, int H, int W,
                      void* stream) {
  if (sy < 1 || sy > MAXS || sx < 1 || sx > MAXS || H % (8 * sy) ||
      W % (8 * sx) || (dq == nullptr) != (pgrad == nullptr) ||
      (dq == nullptr) != (iq == nullptr))
    return (int)cudaErrorInvalidValue;
  OneParams p;
  p.e = e;
  p.g = g;
  p.scale = scale;
  p.fnew = fnew;
  p.part = part;
  p.W = W;
  p.ch.lo = lo;
  p.ch.hi = hi;
  p.ch.dq = dq;
  p.ch.iq = iq;
  p.ch.pgrad = pgrad;
  p.ch.pa = pa;
  p.ch.sy = sy;
  p.ch.sx = sx;
  p.ch.nbx = W / (8 * sx);
  p.ch.nbx4 = (p.ch.nbx + KB - 1) / KB;
  p.ch.block0 = 0;
  const int nblocks = (H / (8 * sy)) * p.ch.nbx4;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (sy * 8 + sx) {
    case 9: err = launch_one<1, 1>(p, nblocks, s); break;
    case 10: err = launch_one<1, 2>(p, nblocks, s); break;
    case 17: err = launch_one<2, 1>(p, nblocks, s); break;
    case 18: err = launch_one<2, 2>(p, nblocks, s); break;
    default: err = launch_one<0, 0>(p, nblocks, s); break;
  }
  if (err != cudaSuccess) return (int)err;
  Ranges r;
  r.start[0] = 0;
  r.start[1] = nblocks;
  r.prob[0] = dq != nullptr;
  reduce_dists<<<1, NT, 0, s>>>(part, r, dist);
  return (int)cudaGetLastError();
}

}  // extern "C"
