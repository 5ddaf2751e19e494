// K3: the raw 1D sparse-convolution noise sum along the iso-ray axis, and
// K3b: its backward.
//
// Replaces tungsten_tpu/ops/sparse_conv_pallas.py::_noise_kernel_1d (body
// _lattice_sum_1d, launched by _noise1d_sum_pallas).  For each point with
// iso-ray coordinate pz it sums, over the 3 lattice cells around pz and K
// impulses per cell, w * exp(-0.5 (kr d)^2) where d is the offset from the
// impulse in cell units, the impulse position and its +-1 weight come from
// xxhash32 counters keyed by the cell, and the sum is cut off at d^2 < 1.
//
// What bounds it: integer and float ALU.  A point costs 3 xxhash32_2 cell
// keys and 3 * 2K xxhash32_2 variates plus 3K expf -- about 650 operations
// at K = 3 -- against 12 bytes moved (4 pz, 4 seed, 4 out).  In a render,
// each launch is one march step of a ray batch, so launch overhead is far
// larger than either bound; the lever for later is a fused march (one
// thread per ray running the step loop in-kernel), not this kernel.
//
// Design: simple and exact first.  One thread per point, 256 threads per
// block, a grid-stride loop over the points; kr and inv_r are passed by
// value; the 3 cells and K impulses are unrolled for K = 3, with a
// runtime-K instantiation for other counts.  The arithmetic follows the TPU
// kernel op for op: the cell coordinate is pz * inv_r (not pz / kr), the
// cell index is (uint32)(int32)floor, keys are xxhash32_2(cell, seed) + 1,
// variates are (h >> 8) * 2^-24 at counters 2k (position) and 2k + 1
// (sign), and the sum runs cell by cell, impulse by impulse.  Built without
// fast math and with -fmad=false, so float rounding follows the plain
// PyTorch twin (kernels/noise1d.py) operation for operation.
//
// K3b replaces tungsten_tpu/ops/sparse_conv_pallas.py::_noise1d_sum_bwd, the
// JAX package's XLA re-trace of _lattice_sum_1d under jax.vjp.  It has K3's
// per-point walk (the same hashes, cells and cut-off, K = 3 unrolled by the
// same template) and writes the partial of the sum in pz per point, scaled
// by the point's cotangent, and the partial in kr summed over points.
// Like K3 it is bound by integer and float ALU: it skips the sign hash and
// expf of impulses out of reach, and moves 16 bytes a point (pz, seed,
// cotangent in; dpz out).  Its design for the H100: one thread per point
// in K3's order of terms (so dpz is bit-equal to the twin), the grid one
// whole wave (the occupancy query's blocks per SM on every SM) that
// strides over the points.  Each thread adds its points' partials in kr
// and inv_r in float64, and grid_sum.cuh sums them over the grid in a
// fixed order (each block's threads, then the last block to take a ticket
// over the blocks), which then writes d/dkr = S_kr - S_inv_r inv_r^2
// (inv_r = 1 / kr): one launch, deterministic, no host sync.  A warp
// still runs an impulse's long path when any lane has it within reach,
// about 1.5 times the work within reach; K1b's shared-memory ring would
// save at most that third and costs a store and a load per entry.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_sum.cuh"

namespace {

constexpr uint32_t P2 = 2246822519u;
constexpr uint32_t P3 = 3266489917u;
constexpr uint32_t P4 = 668265263u;
constexpr uint32_t P5 = 374761393u;
constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 4096;

__device__ __forceinline__ uint32_t rotl17(uint32_t x) {
  return (x << 17) | (x >> 15);
}

__device__ __forceinline__ uint32_t xxhash32_2(uint32_t x, uint32_t y) {
  uint32_t h = y + P5 + x * P3;
  h = P4 * rotl17(h);
  h = P2 * (h ^ (h >> 15));
  h = P3 * (h ^ (h >> 13));
  return h ^ (h >> 16);
}

__device__ __forceinline__ float u01(uint32_t u) {
  return (float)(u >> 8) * (1.0f / 16777216.0f);
}

// KC > 0: the impulse count, fixed at compile time; KC == 0: k_runtime.
template <int KC>
__global__ void __launch_bounds__(THREADS)
noise1d_sum_kernel(const float* __restrict__ pz,
                   const uint32_t* __restrict__ seed,
                   float* __restrict__ out, int n, float kr, float inv_r,
                   int k_runtime) {
  const int impulses = KC > 0 ? KC : k_runtime;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const float tg = pz[i] * inv_r;
    const float b = floorf(tg);
    const float fr = tg - b;
    const uint32_t i0 = (uint32_t)(int32_t)b;
    const uint32_t sd = seed[i];
    float total = 0.0f;
#pragma unroll
    for (int off = -1; off <= 1; ++off) {
      const uint32_t h = xxhash32_2(i0 + (uint32_t)off, sd) + 1u;
      const float q = fr - (float)off;
#pragma unroll
      for (int k = 0; k < impulses; ++k) {
        const float ti = u01(xxhash32_2(h, 2u * (uint32_t)k));
        const float w =
            u01(xxhash32_2(h, 2u * (uint32_t)k + 1u)) < 0.5f ? -1.0f : 1.0f;
        const float d = q - ti;
        const float dt = kr * d;
        total = total + (d * d < 1.0f ? w * expf(-0.5f * dt * dt) : 0.0f);
      }
    }
    out[i] = total;
  }
}

// K3b.  Over the in-reach impulses (d^2 < 1) of the 3 cells it sums
// c = w exp(-0.5 dt^2) (-dt), dt = kr d, the derivative of a term in dt
// (S), and c d (T).  The cell coordinate is tg = pz inv_r, and the offset
// d moves with tg one for one (the floor is piecewise constant), so the
// partials of the sum, scaled by the point's cotangent g, are
//   d/dpz    = g S kr inv_r,
//   d/dkr    = g T                (kr in dt = kr d),
//   d/dinv_r = g S kr pz          (inv_r in tg),
// dpz [N] written per point, the other two summed over points in float64
// and combined into the one float32 d/dkr through inv_r = 1 / kr.
// 1024 threads a block: two blocks fill an SM's 64 warps, and the last
// block of a wave of 264 sums the blocks' partials with one load a thread
// (timed a little ahead of 256 and 512 threads on an H100).
constexpr int K3B_THREADS = 1024;

template <int KC>
__global__ void __launch_bounds__(K3B_THREADS)
noise1d_sum_bwd_kernel(const float* __restrict__ pz,
                       const uint32_t* __restrict__ seed,
                       const float* __restrict__ g, float* __restrict__ dpz,
                       double* __restrict__ block_sums,
                       unsigned* __restrict__ ticket,
                       float* __restrict__ dkr, int n, float kr,
                       float inv_r, int k_runtime) {
  const int impulses = KC > 0 ? KC : k_runtime;
  double acc[2] = {0.0, 0.0};  // the partials in kr and in inv_r
  for (int i = blockIdx.x * K3B_THREADS + threadIdx.x; i < n;
       i += gridDim.x * K3B_THREADS) {
    const float z = pz[i];
    const float tg = z * inv_r;
    const float b = floorf(tg);
    const float fr = tg - b;
    const uint32_t i0 = (uint32_t)(int32_t)b;
    const uint32_t sd = seed[i];
    float s = 0.0f;
    float t = 0.0f;
#pragma unroll
    for (int off = -1; off <= 1; ++off) {
      const uint32_t h = xxhash32_2(i0 + (uint32_t)off, sd) + 1u;
#pragma unroll
      for (int k = 0; k < impulses; ++k) {
        const float ti = u01(xxhash32_2(h, 2u * (uint32_t)k));
        const float d = (fr - (float)off) - ti;
        if (d * d < 1.0f) {
          const float w = u01(xxhash32_2(h, 2u * (uint32_t)k + 1u)) < 0.5f
              ? -1.0f : 1.0f;
          const float dt = kr * d;
          const float c = w * expf(-0.5f * dt * dt) * -dt;
          s = s + c;
          t = t + c * d;
        }
      }
    }
    const float ct = g[i];
    dpz[i] = ct * s * kr * inv_r;
    acc[0] += (double)(ct * t);
    acc[1] += (double)(ct * s * kr * z);
  }
  if (grid_sum<2, K3B_THREADS>(acc, block_sums, ticket)) {
    const double ir = (double)inv_r;
    *dkr = (float)(acc[0] - acc[1] * (ir * ir));
  }
}

}  // namespace

// The launchers run their kernel on `stream` of `device`, then make the
// caller's current device current again; each returns the launch's
// cudaGetLastError() as an int.

// K3.
extern "C" int noise1d_sum(const void* pz, const void* seed, void* out, int n,
                           float kr, float inv_r, int impulse_count,
                           int device, void* stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    int blocks = (n + THREADS - 1) / THREADS;
    if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
    const cudaStream_t s = (cudaStream_t)stream;
    if (impulse_count == 3) {
      noise1d_sum_kernel<3><<<blocks, THREADS, 0, s>>>(
          (const float*)pz, (const uint32_t*)seed, (float*)out, n, kr, inv_r,
          3);
    } else {
      noise1d_sum_kernel<0><<<blocks, THREADS, 0, s>>>(
          (const float*)pz, (const uint32_t*)seed, (float*)out, n, kr, inv_r,
          impulse_count);
    }
  }
  err = cudaGetLastError();
  const cudaError_t restore = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restore);
}

using K3bKernel = void (*)(const float*, const uint32_t*, const float*,
                           float*, double*, unsigned*, float*, int, float,
                           float, int);

// K3b's grid for n points on `device` (current on entry and exit): one
// whole wave, the occupancy query's blocks per SM on every SM, or fewer
// when n fills fewer blocks; at least 1.
static cudaError_t k3b_grid(K3bKernel kernel, int n, int device,
                            int* blocks) {
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        K3B_THREADS, 0);
  }
  const int need = (n + K3B_THREADS - 1) / K3B_THREADS;
  *blocks = need < sms * per_sm ? need : sms * per_sm;
  if (*blocks < 1) *blocks = 1;
  return err;
}

static K3bKernel k3b_kernel(int impulse_count) {
  if (impulse_count == 3) return noise1d_sum_bwd_kernel<3>;
  return noise1d_sum_bwd_kernel<0>;
}

extern "C" int noise1d_sum_bwd_grid(int n, int impulse_count, int device,
                                    int* blocks) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = k3b_grid(k3b_kernel(impulse_count), n, device, blocks);
  const cudaError_t restore = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restore);
}

// K3b on `blocks` blocks (noise1d_sum_bwd_grid): dpz [n], and dkr [1]
// through block_sums [blocks, 2] (float64 scratch) and the ticket, a
// device word at 0 that the launch leaves at 0.
extern "C" int noise1d_sum_bwd(const void* pz, const void* seed,
                               const void* g, void* dpz, void* block_sums,
                               void* ticket, void* dkr, int n, int blocks,
                               float kr, float inv_r, int impulse_count,
                               int device, void* stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const K3bKernel kernel = k3b_kernel(impulse_count);
  kernel<<<blocks, K3B_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)pz, (const uint32_t*)seed, (const float*)g, (float*)dpz,
      (double*)block_sums, (unsigned*)ticket, (float*)dkr, n, kr, inv_r,
      impulse_count);
  err = cudaGetLastError();
  const cudaError_t restore = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restore);
}
