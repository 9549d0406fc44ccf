// K5: the lite projection (bf16 side state, boxes from int16 + quant), for
// Hopper.
//
// Replaces the Pallas kernel
// jpeg2png_tpu/kernels/project_step.py::fused_project_multi_lite
// (_kernel_multi_lite, _stripe_math_lite).  For every channel c of a
// [C, H, W] canvas with footprint (sy, sx) and coefficient rasters
// [H/sy, W/sx] (reference: compute.c:209-216, 323-404, 38-70):
//
//   fmid  = (f + factor * d) - scale[c] * g   (d, g in bf16)
//   m     = footprint mean of fmid            (8 x 8 per coefficient block)
//   coefs = D m D^T
//   clamp = clip(coefs, data*q - q/2, data*q + q/2)
//   fnew  = (fmid - upsample(m)) + upsample(D^T clamp D)
//   dnew  = bf16(fnew - f)                    (the next FISTA difference)
//   iq    = 1/q for 0 < q < 2^39, else 0
//   devp  = (clamp - dq) * iq,  devq = bf16(devp * iq),  dist[c] = 0.5 sum devp^2
//
// q == 0 marks frozen canvas padding (box [0, 0]) and q >= 2^39 a region
// gap (unconstrained box), as in K3 (csrc/iter_step.cu).  fnew is the
// reference's mean/residual reconstruction, like K2 (csrc/project_step.cu),
// not the TPU kernel's correction form with a single-pass bf16 backward
// transform; the transforms are plain f32.
//
// Bound on an H100: device memory.  Per pixel and channel it reads f (4 B),
// d and g (2 B each) and writes fnew (4 B) and dnew (2 B); per coefficient it
// reads data (2 B) and q (4 B) and writes devq (2 B), against two 8x8
// transform pairs per coefficient block.
// Design: K2's: a block of 256 threads takes four horizontally
// neighbouring coefficient blocks of one channel, one thread per
// coefficient; the footprint's second read (for the residual and dnew)
// hits the caches; one distance partial per block, reduced per channel in
// a fixed order by a second kernel (no float atomics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads: 8 coefficient rows x 4 blocks x 8 columns
constexpr int KB = 4;     // coefficient blocks per thread block
constexpr int MAXC = 4;
constexpr float FREE_Q_MIN = 549755813888.f;   // 2^39

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

struct Chan {
  const int16_t* data;  // [H/sy, W/sx] quantized coefficients
  const float* q;       // [H/sy, W/sx] quant raster
  uint16_t* devq;       // [H/sy, W/sx] bf16 prob carry out, or null (off)
  int sy, sx;
  int nbx;              // coefficient blocks per row
  int nbx4;             // thread blocks per coefficient-block row
  int block0;           // first thread block of this channel
};

struct Params {
  const float* f;
  const uint16_t* d;
  const uint16_t* g;
  const float* scales;  // [C] step_size / |grad_c| on the device
  float* fnew;
  uint16_t* dnew;
  float* part;          // [nblocks] distance partials
  float factor;
  int C, H, W;
  Chan ch[MAXC];
};

__global__ void __launch_bounds__(NT) project_lite_kernel(Params p) {
  __shared__ float D[64];
  __shared__ float A[KB][8][9];   // footprint means, then clamped coefs
  __shared__ float T[KB][8][9];   // transform intermediate
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
  const float factor = p.factor;
  const float* f = p.f + c * HW;
  const uint16_t* d = p.d + c * HW;
  const uint16_t* g = p.g + c * HW;

  // 1. normalized step on this coefficient's footprint, summed for its mean
  const int py0 = cby * 8 * sy + u * sy, px0 = bx * 8 * sx + v * sx;
  float sum = 0.f;
  if (active) {
    for (int i = 0; i < sy; ++i)
      for (int j = 0; j < sx; ++j) {
        const size_t o = (size_t)(py0 + i) * W + (px0 + j);
        const float e = f[o] + factor * bf2f(d[o]);
        sum += e - scale * bf2f(g[o]);
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

  // 3. box from the int16 + quant rasters, projection, prob carry
  const int wc = W / sx;
  const size_t co = (size_t)(cby * 8 + u) * wc + (bx * 8 + v);
  float cl = 0.f, dist = 0.f;
  if (active) {
    const float q = __ldg(ch.q + co);
    const float dq = (float)__ldg(ch.data + co) * q;
    cl = fminf(fmaxf(coef, dq - 0.5f * q), dq + 0.5f * q);
    if (ch.devq) {
      const float iq = (q > 0.f && q < FREE_Q_MIN) ? 1.f / q : 0.f;
      const float devp = (cl - dq) * iq;
      dist = devp * devp;
      ch.devq[co] = f2bf(devp * iq);
    }
  }
  __syncthreads();   // every thread has read T before A / T are rewritten
  A[kb][u][v] = cl;
  __syncthreads();

  // 4. back = D^T clamp D
  s = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += A[kb][u][k] * D[k * 8 + v];
  T[kb][u][v] = s;
  __syncthreads();
  float back = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) back += D[k * 8 + u] * T[kb][k][v];

  // 5. the footprint: fnew and dnew once per pixel
  if (active) {
    for (int i = 0; i < sy; ++i)
      for (int j = 0; j < sx; ++j) {
        const size_t o = (size_t)(py0 + i) * W + (px0 + j);
        const float fv = f[o];
        const float e = fv + factor * bf2f(d[o]);
        const float fm = e - scale * bf2f(g[o]);
        const float fn = (fm - mean) + back;
        p.fnew[c * HW + o] = fn;
        p.dnew[c * HW + o] = f2bf(fn - fv);
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

// f, fnew: [C, H, W] f32; d, g, dnew: [C, H, W] bf16; scales: [C] (device).
// ptrs[3c..3c+2]: data (int16), q (f32), devq out (bf16, 0 when channel c's
// prob term is off), each [H/sy, W/sx]; ints[2c..2c+1]: sy, sx.
// part: [sum_c (H / (8 sy)) * ceil(W / (8 sx) / 4)]; dists: [C].
// Returns the first cudaGetLastError() that is not cudaSuccess, else 0.
int j2p_fused_project_lite(const float* f, const uint16_t* d,
                           const uint16_t* g, const float* scales,
                           float* fnew, uint16_t* dnew, float* part,
                           float* dists, const uint64_t* ptrs,
                           const int* ints, float factor, int C, int H,
                           int W, void* stream) {
  if (C < 1 || C > MAXC) return (int)cudaErrorInvalidValue;
  Params p;
  p.f = f;
  p.d = d;
  p.g = g;
  p.scales = scales;
  p.fnew = fnew;
  p.dnew = dnew;
  p.part = part;
  p.factor = factor;
  p.C = C;
  p.H = H;
  p.W = W;
  Ranges r;
  int nblocks = 0;
  for (int c = 0; c < C; ++c) {
    Chan& ch = p.ch[c];
    ch.data = (const int16_t*)ptrs[3 * c];
    ch.q = (const float*)ptrs[3 * c + 1];
    ch.devq = (uint16_t*)ptrs[3 * c + 2];
    ch.sy = ints[2 * c];
    ch.sx = ints[2 * c + 1];
    if (ch.sy < 1 || ch.sy > 4 || ch.sx < 1 || ch.sx > 4 ||
        H % (8 * ch.sy) || W % (8 * ch.sx))
      return (int)cudaErrorInvalidValue;
    ch.nbx = W / (8 * ch.sx);
    ch.nbx4 = (ch.nbx + KB - 1) / KB;
    ch.block0 = nblocks;
    r.start[c] = nblocks;
    r.prob[c] = ch.devq != nullptr;
    nblocks += (H / (8 * ch.sy)) * ch.nbx4;
  }
  r.start[C] = nblocks;
  cudaStream_t s = (cudaStream_t)stream;
  project_lite_kernel<<<nblocks, NT, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_dists<<<C, NT, 0, s>>>(part, r, dists);
  return (int)cudaGetLastError();
}

}  // extern "C"
