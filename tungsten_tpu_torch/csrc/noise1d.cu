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
// shape (one thread per point, the same hashes, cells and cut-off, K = 3
// unrolled by the same template) and writes the partials of the sum in pz,
// kr and inv_r, each scaled by the point's cotangent; the caller sums the
// last two over points.  Like K3 it is bound by integer and float ALU: it
// skips the sign hash and expf of impulses out of reach, and moves 24 bytes
// a point (pz, seed, cotangent in; dpz and two partials out).

#include <cuda_runtime.h>
#include <stdint.h>

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
// written as dpz [N] and the per-point partials [N, 2] of (kr, inv_r).
template <int KC>
__global__ void __launch_bounds__(THREADS)
noise1d_sum_bwd_kernel(const float* __restrict__ pz,
                       const uint32_t* __restrict__ seed,
                       const float* __restrict__ g, float* __restrict__ dpz,
                       float* __restrict__ part, int n, float kr,
                       float inv_r, int k_runtime) {
  const int impulses = KC > 0 ? KC : k_runtime;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
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
      const float q = fr - (float)off;
#pragma unroll
      for (int k = 0; k < impulses; ++k) {
        const float ti = u01(xxhash32_2(h, 2u * (uint32_t)k));
        const float d = q - ti;
        if (d * d < 1.0f) {
          const float w =
              u01(xxhash32_2(h, 2u * (uint32_t)k + 1u)) < 0.5f ? -1.0f : 1.0f;
          const float dt = kr * d;
          const float c = w * expf(-0.5f * dt * dt) * -dt;
          s = s + c;
          t = t + c * d;
        }
      }
    }
    const float ct = g[i];
    dpz[i] = ct * s * kr * inv_r;
    part[2 * i + 0] = ct * t;
    part[2 * i + 1] = ct * s * kr * z;
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

// K3b.
extern "C" int noise1d_sum_bwd(const void* pz, const void* seed,
                               const void* g, void* dpz, void* part, int n,
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
      noise1d_sum_bwd_kernel<3><<<blocks, THREADS, 0, s>>>(
          (const float*)pz, (const uint32_t*)seed, (const float*)g,
          (float*)dpz, (float*)part, n, kr, inv_r, 3);
    } else {
      noise1d_sum_bwd_kernel<0><<<blocks, THREADS, 0, s>>>(
          (const float*)pz, (const uint32_t*)seed, (const float*)g,
          (float*)dpz, (float*)part, n, kr, inv_r, impulse_count);
    }
  }
  err = cudaGetLastError();
  const cudaError_t restore = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restore);
}
