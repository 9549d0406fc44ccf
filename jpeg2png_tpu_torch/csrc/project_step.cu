// K2: fused normalized step + box projection + prob gradient, for Hopper.
//
// Replaces the Pallas kernel
// jpeg2png_tpu/kernels/project_step.py::fused_project_multi
// (_kernel_multi, _stripe_math).  For every channel c of a [C, H, W] f32
// canvas, with footprint (sy, sx) and coefficient rasters [H/sy, W/sx]
// (reference: compute.c:209-216, 334-404, 38-70):
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
// by a second kernel (no float atomics).

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

__global__ void __launch_bounds__(NT) project_kernel(Params p) {
  // 8x8 tiles padded to 9 columns: lanes of one warp that read column j
  // of the four blocks then hit four different banks
  __shared__ float D[64];
  __shared__ float A[KB][8][9];   // footprint means, then clamped coefs
  __shared__ float T[KB][8][9];   // transform intermediate
  __shared__ float B[KB][8][9];   // devp * iq
  __shared__ float T2[KB][8][9];
  __shared__ float red[NT / 32];

  const int tid = threadIdx.x;
  if (tid < 64) D[tid] = c_D[tid];

  int c = 0;
  while (c + 1 < p.C && (int)blockIdx.x >= p.ch[c + 1].block0) ++c;
  const Chan ch = p.ch[c];
  const int local = blockIdx.x - ch.block0;
  const int cby = local / ch.nbx4;
  const int bx = (local % ch.nbx4) * KB + (tid & 31) / 8;
  const int u = tid >> 5, v = tid & 7, kb = (tid & 31) >> 3;
  const bool active = bx < ch.nbx;
  const int sy = ch.sy, sx = ch.sx;
  const int W = p.W;
  const size_t HW = (size_t)p.H * W;
  const float scale = p.scales[c];
  const bool prob = ch.dq != nullptr;

  // 1. normalized step on this coefficient's footprint, summed for its
  //    mean.  Step 5 reads the footprint again (from L1/L2) instead of
  //    holding up to 16 values in registers for the whole block: fewer
  //    registers, more resident blocks to hide memory latency.
  const int py0 = cby * 8 * sy + u * sy, px0 = bx * 8 * sx + v * sx;
  const float* e = p.e + c * HW;
  const float* g = p.g + c * HW;
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
  A[kb][u][v] = mean;
  __syncthreads();

  // 2. coefs = D m D^T
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += A[kb][u][j] * D[v * 8 + j];
  T[kb][u][v] = s;
  __syncthreads();
  float coef = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) coef += D[u * 8 + i] * T[kb][i][v];

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
  A[kb][u][v] = cl;
  B[kb][u][v] = dd;
  __syncthreads();

  // 4. back = D^T clamp D (and D^T dd D for the prob gradient)
  s = 0.f;
  float s2 = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    s += A[kb][u][k] * D[k * 8 + v];
    s2 += B[kb][u][k] * D[k * 8 + v];
  }
  T[kb][u][v] = s;
  T2[kb][u][v] = s2;
  __syncthreads();
  float back = 0.f, pback = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    back += D[k * 8 + u] * T[kb][k][v];
    pback += D[k * 8 + u] * T2[kb][k][v];
  }

  // 5. write the footprint: fnew (and pgrad) once per pixel
  if (active) {
    const float pg = ch.pa * pback;
    for (int i = 0; i < sy; ++i)
      for (int j = 0; j < sx; ++j) {
        const size_t o = (size_t)(py0 + i) * W + (px0 + j);
        const float fm = e[o] - scale * g[o];
        p.fnew[c * HW + o] = (fm - mean) + back;
        if (ch.pgrad) ch.pgrad[o] = pg;
      }
  }

  // 6. this block's distance partial, fixed-order reduction
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) dist += __shfl_down_sync(0xffffffffu, dist, o);
  if ((tid & 31) == 0) red[tid >> 5] = dist;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int w = 0; w < NT / 32; ++w) t += red[w];
    p.part[blockIdx.x] = t;
  }
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

}  // extern "C"
