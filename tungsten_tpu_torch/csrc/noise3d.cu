// K1 and K2: the raw 3D sparse-convolution noise sum; K1b and K2b: their
// backwards.
//
// K1 (noise3d_sum_s_kernel) replaces
// tungsten_tpu/ops/sparse_conv_pallas.py::_noise_kernel_scalar (launched by
// _noise3d_sum_pallas_s): scalar cell radius kr, with the scalar
// quadratic-form scale qm pre-folded into m6 by the caller.  K2
// (noise3d_sum_kernel) replaces ::_noise_kernel (launched by
// _noise3d_sum_pallas): per-point kr and qm, the multi-resolution levels of
// a nonstationary covariance.  For each query point p both sum, over the 27
// lattice cells around p and K impulses per cell, w * exp(-q) where the
// impulse offset and its +-1 weight come from xxhash32 counters keyed by the
// cell, q is the splat's quadratic form (m6 at cell radius kr, times qm for
// K2), and the sum is cut off at r^2 < 1 in cell units.  K1b
// (noise3d_sum_s_bwd_kernel) replaces ::_noise3d_sum_s_bwd, which the JAX
// package runs as an XLA re-trace (jax.vjp) of the same lattice sum: the
// partials of K1's sum in p, kr and the diagonal of m6, for a diagonal
// splat form.  K2b (noise3d_sum_bwd_kernel) replaces ::_noise3d_sum_bwd, the
// same re-trace for K2: the partials in p, the per-point kr and qm and the
// diagonal of m6.
//
// What bounds them: integer ALU.  A point costs 27 xxhash32_4 cell keys and
// 27 * 4K xxhash32_2 variates -- about 330 hashes, thousands of 32-bit
// integer operations -- against 20 bytes moved for K1 (12 in, 4 seed, 4
// out) and 28 for K2 (its kr and qm).  K2 adds a per-point reciprocal and
// 27 * K multiplies by qm.  K1b hashes as K1 does and adds 12 float
// operations per impulse within reach, against 48 bytes (p, seed and the
// cotangent in; 3 + 4 partials out); K2b likewise against 60 (kr and qm
// in too, 3 + 5 partials out).  The lever for later is data reuse:
// neighbouring points share most of their 27 cells and all of those cells'
// impulses, so a block could hash each cell once into shared memory instead
// of once per point.
//
// Design: simple and exact first.  One thread per point, 256 threads per
// block, a masked tail and no padding; p is read as [N,3] AoS; m6 (and K1's
// kr) are passed by value; K is a runtime int.  Blocks keep no state between
// them.  The arithmetic follows the TPU kernels op for op: inv_r = 1 / kr,
// gx = px * inv_r, the cell index is (uint32)(int32)floor(g), keys are
// hashed in (z, y, x, seed) order, variates are (h >> 8) * 2^-24, K2 scales
// the finished quadratic form (q = qm * quad), and the sum runs dx, dy, dz,
// k.  K1b and K2b accumulate their nine sums per point in registers in the
// same order, with their loops kept rolled so that their SASS has K1's loop
// shape, and leave the sum over points to the caller (no atomics).  Built
// without fast math and with -fmad=false, so float rounding follows the
// plain PyTorch twins (kernels/noise3d.py) operation for operation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t P2 = 2246822519u;
constexpr uint32_t P3 = 3266489917u;
constexpr uint32_t P4 = 668265263u;
constexpr uint32_t P5 = 374761393u;

__device__ __forceinline__ uint32_t rotl17(uint32_t x) {
  return (x << 17) | (x >> 15);
}

__device__ __forceinline__ uint32_t final_mix(uint32_t h) {
  h = P2 * (h ^ (h >> 15));
  h = P3 * (h ^ (h >> 13));
  return h ^ (h >> 16);
}

__device__ __forceinline__ uint32_t xxhash32_2(uint32_t x, uint32_t y) {
  uint32_t h = y + P5 + x * P3;
  h = P4 * rotl17(h);
  return final_mix(h);
}

__device__ __forceinline__ uint32_t xxhash32_4(uint32_t x, uint32_t y,
                                               uint32_t z, uint32_t w) {
  uint32_t h = w + P5 + x * P3;
  h = P4 * rotl17(h);
  h = h + y * P3;
  h = P4 * rotl17(h);
  h = h + z * P3;
  h = P4 * rotl17(h);
  return final_mix(h);
}

__device__ __forceinline__ float u01(uint32_t u) {
  return (float)(u >> 8) * (1.0f / 16777216.0f);
}

// The 27 x K sum at one point; kQm scales each quadratic form by qm.
template <bool kQm>
__device__ __forceinline__ float lattice_sum(float px, float py, float pz,
                                             uint32_t sd, float kr, float qm,
                                             float m00, float m11, float m22,
                                             float m01, float m02, float m12,
                                             int impulse_count) {
  const float inv_r = 1.0f / kr;
  const float gx = px * inv_r;
  const float gy = py * inv_r;
  const float gz = pz * inv_r;
  const float bx = floorf(gx);
  const float by = floorf(gy);
  const float bz = floorf(gz);
  const float fx = gx - bx;
  const float fy = gy - by;
  const float fz = gz - bz;
  const uint32_t ix = (uint32_t)(int32_t)bx;
  const uint32_t iy = (uint32_t)(int32_t)by;
  const uint32_t iz = (uint32_t)(int32_t)bz;

  float total = 0.0f;
  for (int dx = -1; dx <= 1; ++dx) {
    for (int dy = -1; dy <= 1; ++dy) {
      for (int dz = -1; dz <= 1; ++dz) {
        const uint32_t cx = ix + (uint32_t)dx;
        const uint32_t cy = iy + (uint32_t)dy;
        const uint32_t cz = iz + (uint32_t)dz;
        const uint32_t h = xxhash32_4(cz, cy, cx, sd) + 1u;
        const float qx = fx - (float)dx;
        const float qy = fy - (float)dy;
        const float qz = fz - (float)dz;
        for (int k = 0; k < impulse_count; ++k) {
          const uint32_t c = 4u * (uint32_t)k;
          const float ux = u01(xxhash32_2(h, c));
          const float uy = u01(xxhash32_2(h, c + 1u));
          const float uz = u01(xxhash32_2(h, c + 2u));
          const float uw = u01(xxhash32_2(h, c + 3u));
          const float ddx = qx - ux;
          const float ddy = qy - uy;
          const float ddz = qz - uz;
          const float r2 = ddx * ddx + ddy * ddy + ddz * ddz;
          const float abx = kr * ddx;
          const float aby = kr * ddy;
          const float abz = kr * ddz;
          float q = m00 * abx * abx + m11 * aby * aby + m22 * abz * abz
              + 2.0f * (m01 * abx * aby + m02 * abx * abz + m12 * aby * abz);
          if (kQm) q = qm * q;
          const float w = uw < 0.5f ? -1.0f : 1.0f;
          total = total + (r2 < 1.0f ? w * expf(-q) : 0.0f);
        }
      }
    }
  }
  return total;
}

__global__ void __launch_bounds__(256)
noise3d_sum_s_kernel(const float* __restrict__ p,
                     const uint32_t* __restrict__ seed,
                     float* __restrict__ out, int n, float kr, float m00,
                     float m11, float m22, float m01, float m02, float m12,
                     int impulse_count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = lattice_sum<false>(p[3 * i + 0], p[3 * i + 1], p[3 * i + 2],
                              seed[i], kr, 1.0f, m00, m11, m22, m01, m02,
                              m12, impulse_count);
}

__global__ void __launch_bounds__(256)
noise3d_sum_kernel(const float* __restrict__ p,
                   const uint32_t* __restrict__ seed,
                   const float* __restrict__ kr,
                   const float* __restrict__ qm, float* __restrict__ out,
                   int n, float m00, float m11, float m22, float m01,
                   float m02, float m12, int impulse_count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = lattice_sum<true>(p[3 * i + 0], p[3 * i + 1], p[3 * i + 2],
                             seed[i], kr[i], qm[i], m00, m11, m22, m01, m02,
                             m12, impulse_count);
}

// K1b: the backward of K1.  For each point it walks the same 27 cells and K
// impulses, with the same hashes and cut-off, and accumulates each in-reach
// term e = w exp(-q) times the splat's offset ab = kr dd (S), times ab dd
// (T) and times ab^2 (Q), per axis.  With the diagonal form m (m01 = m02 =
// m12 = 0, as in every ported covariance) the partials of the sum, scaled by
// the point's cotangent g, are
//   d/dp_i   = g (-2 m_ii S_i) kr / kr,
//   d/dkr    = g sum_i -2 m_ii (T_i - S_i p_i / kr),
//   d/dm_ii  = -g Q_i,
// written as dp [N, 3] and the per-point partials [N, 4] of (kr, m00, m11,
// m22), which the caller sums over points.
__global__ void __launch_bounds__(256)
noise3d_sum_s_bwd_kernel(const float* __restrict__ p,
                         const uint32_t* __restrict__ seed,
                         const float* __restrict__ g, float* __restrict__ dp,
                         float* __restrict__ part, int n, float kr, float m00,
                         float m11, float m22, int impulse_count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float px = p[3 * i + 0];
  const float py = p[3 * i + 1];
  const float pz = p[3 * i + 2];
  const uint32_t sd = seed[i];
  const float inv_r = 1.0f / kr;
  const float gx = px * inv_r;
  const float gy = py * inv_r;
  const float gz = pz * inv_r;
  const float bx = floorf(gx);
  const float by = floorf(gy);
  const float bz = floorf(gz);
  const float fx = gx - bx;
  const float fy = gy - by;
  const float fz = gz - bz;
  const uint32_t ix = (uint32_t)(int32_t)bx;
  const uint32_t iy = (uint32_t)(int32_t)by;
  const uint32_t iz = (uint32_t)(int32_t)bz;

  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  float tx = 0.0f, ty = 0.0f, tz = 0.0f;
  float qx2 = 0.0f, qy2 = 0.0f, qz2 = 0.0f;
#pragma unroll 1
  for (int dx = -1; dx <= 1; ++dx) {
#pragma unroll 1
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll 1
      for (int dz = -1; dz <= 1; ++dz) {
        const uint32_t cx = ix + (uint32_t)dx;
        const uint32_t cy = iy + (uint32_t)dy;
        const uint32_t cz = iz + (uint32_t)dz;
        const uint32_t h = xxhash32_4(cz, cy, cx, sd) + 1u;
        const float qx = fx - (float)dx;
        const float qy = fy - (float)dy;
        const float qz = fz - (float)dz;
#pragma unroll 1
        for (int k = 0; k < impulse_count; ++k) {
          const uint32_t c = 4u * (uint32_t)k;
          const float ux = u01(xxhash32_2(h, c));
          const float uy = u01(xxhash32_2(h, c + 1u));
          const float uz = u01(xxhash32_2(h, c + 2u));
          const float ddx = qx - ux;
          const float ddy = qy - uy;
          const float ddz = qz - uz;
          const float r2 = ddx * ddx + ddy * ddy + ddz * ddz;
          if (r2 < 1.0f) {
            const float uw = u01(xxhash32_2(h, c + 3u));
            const float abx = kr * ddx;
            const float aby = kr * ddy;
            const float abz = kr * ddz;
            const float q = m00 * abx * abx + m11 * aby * aby
                + m22 * abz * abz;
            const float w = uw < 0.5f ? -1.0f : 1.0f;
            const float e = w * expf(-q);
            const float ex = e * abx;
            const float ey = e * aby;
            const float ez = e * abz;
            sx = sx + ex;
            sy = sy + ey;
            sz = sz + ez;
            tx = tx + ex * ddx;
            ty = ty + ey * ddy;
            tz = tz + ez * ddz;
            qx2 = qx2 + ex * abx;
            qy2 = qy2 + ey * aby;
            qz2 = qz2 + ez * abz;
          }
        }
      }
    }
  }
  const float ct = g[i];
  const float c2x = -2.0f * m00;
  const float c2y = -2.0f * m11;
  const float c2z = -2.0f * m22;
  dp[3 * i + 0] = ct * (c2x * sx) * kr * inv_r;
  dp[3 * i + 1] = ct * (c2y * sy) * kr * inv_r;
  dp[3 * i + 2] = ct * (c2z * sz) * kr * inv_r;
  part[4 * i + 0] = ct * (c2x * (tx - sx * gx) + c2y * (ty - sy * gy)
                          + c2z * (tz - sz * gz));
  part[4 * i + 1] = -ct * qx2;
  part[4 * i + 2] = -ct * qy2;
  part[4 * i + 3] = -ct * qz2;
}

// K2b: the backward of K2, K1b's walk with a per-point radius kr and
// quadratic-form scale qm (q = qm * quad, as K2 has it).  With c2_i =
// -2 qm m_ii and S, T, Q as in K1b, the partials scaled by the cotangent g
// are
//   d/dp_i   = g c2_i S_i kr / kr,
//   d/dkr    = g sum_i c2_i (T_i - S_i p_i / kr),
//   d/dqm    = -g sum_i m_ii Q_i,
//   d/dm_ii  = -g qm Q_i,
// written as dp [N, 3] and the per-point partials [N, 5] of (kr, qm, m00,
// m11, m22).  dkr and dqm stay per point (the JAX package's are per lane);
// the caller sums the three m partials over points.
__global__ void __launch_bounds__(256)
noise3d_sum_bwd_kernel(const float* __restrict__ p,
                       const uint32_t* __restrict__ seed,
                       const float* __restrict__ kr_in,
                       const float* __restrict__ qm_in,
                       const float* __restrict__ g, float* __restrict__ dp,
                       float* __restrict__ part, int n, float m00, float m11,
                       float m22, int impulse_count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float px = p[3 * i + 0];
  const float py = p[3 * i + 1];
  const float pz = p[3 * i + 2];
  const uint32_t sd = seed[i];
  const float kr = kr_in[i];
  const float qm = qm_in[i];
  const float inv_r = 1.0f / kr;
  const float gx = px * inv_r;
  const float gy = py * inv_r;
  const float gz = pz * inv_r;
  const float bx = floorf(gx);
  const float by = floorf(gy);
  const float bz = floorf(gz);
  const float fx = gx - bx;
  const float fy = gy - by;
  const float fz = gz - bz;
  const uint32_t ix = (uint32_t)(int32_t)bx;
  const uint32_t iy = (uint32_t)(int32_t)by;
  const uint32_t iz = (uint32_t)(int32_t)bz;

  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  float tx = 0.0f, ty = 0.0f, tz = 0.0f;
  float qx2 = 0.0f, qy2 = 0.0f, qz2 = 0.0f;
#pragma unroll 1
  for (int dx = -1; dx <= 1; ++dx) {
#pragma unroll 1
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll 1
      for (int dz = -1; dz <= 1; ++dz) {
        const uint32_t cx = ix + (uint32_t)dx;
        const uint32_t cy = iy + (uint32_t)dy;
        const uint32_t cz = iz + (uint32_t)dz;
        const uint32_t h = xxhash32_4(cz, cy, cx, sd) + 1u;
        const float qx = fx - (float)dx;
        const float qy = fy - (float)dy;
        const float qz = fz - (float)dz;
#pragma unroll 1
        for (int k = 0; k < impulse_count; ++k) {
          const uint32_t c = 4u * (uint32_t)k;
          const float ux = u01(xxhash32_2(h, c));
          const float uy = u01(xxhash32_2(h, c + 1u));
          const float uz = u01(xxhash32_2(h, c + 2u));
          const float ddx = qx - ux;
          const float ddy = qy - uy;
          const float ddz = qz - uz;
          const float r2 = ddx * ddx + ddy * ddy + ddz * ddz;
          if (r2 < 1.0f) {
            const float uw = u01(xxhash32_2(h, c + 3u));
            const float abx = kr * ddx;
            const float aby = kr * ddy;
            const float abz = kr * ddz;
            const float q = qm * (m00 * abx * abx + m11 * aby * aby
                                  + m22 * abz * abz);
            const float w = uw < 0.5f ? -1.0f : 1.0f;
            const float e = w * expf(-q);
            const float ex = e * abx;
            const float ey = e * aby;
            const float ez = e * abz;
            sx = sx + ex;
            sy = sy + ey;
            sz = sz + ez;
            tx = tx + ex * ddx;
            ty = ty + ey * ddy;
            tz = tz + ez * ddz;
            qx2 = qx2 + ex * abx;
            qy2 = qy2 + ey * aby;
            qz2 = qz2 + ez * abz;
          }
        }
      }
    }
  }
  const float ct = g[i];
  const float c2x = -2.0f * qm * m00;
  const float c2y = -2.0f * qm * m11;
  const float c2z = -2.0f * qm * m22;
  dp[3 * i + 0] = ct * (c2x * sx) * kr * inv_r;
  dp[3 * i + 1] = ct * (c2y * sy) * kr * inv_r;
  dp[3 * i + 2] = ct * (c2z * sz) * kr * inv_r;
  part[5 * i + 0] = ct * (c2x * (tx - sx * gx) + c2y * (ty - sy * gy)
                          + c2z * (tz - sz * gz));
  part[5 * i + 1] = -ct * (m00 * qx2 + m11 * qy2 + m22 * qz2);
  const float cq = -ct * qm;
  part[5 * i + 2] = cq * qx2;
  part[5 * i + 3] = cq * qy2;
  part[5 * i + 4] = cq * qz2;
}

}  // namespace

// The launchers run their kernel on `stream` of `device`, then make the
// caller's current device current again; each returns the launch's
// cudaGetLastError() as an int.

// K1.
extern "C" int noise3d_sum_s(const void* p, const void* seed, void* out, int n,
                             float kr, float m00, float m11, float m22,
                             float m01, float m02, float m12,
                             int impulse_count, int device, void* stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    noise3d_sum_s_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)p, (const uint32_t*)seed, (float*)out, n, kr, m00, m11,
        m22, m01, m02, m12, impulse_count);
  }
  err = cudaGetLastError();
  const cudaError_t restore = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restore);
}

// K1b.
extern "C" int noise3d_sum_s_bwd(const void* p, const void* seed,
                                 const void* g, void* dp, void* part, int n,
                                 float kr, float m00, float m11, float m22,
                                 int impulse_count, int device,
                                 void* stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    noise3d_sum_s_bwd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)p, (const uint32_t*)seed, (const float*)g, (float*)dp,
        (float*)part, n, kr, m00, m11, m22, impulse_count);
  }
  err = cudaGetLastError();
  const cudaError_t restore = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restore);
}

// K2.
extern "C" int noise3d_sum(const void* p, const void* seed, const void* kr,
                           const void* qm, void* out, int n, float m00,
                           float m11, float m22, float m01, float m02,
                           float m12, int impulse_count, int device,
                           void* stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    noise3d_sum_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)p, (const uint32_t*)seed, (const float*)kr,
        (const float*)qm, (float*)out, n, m00, m11, m22, m01, m02, m12,
        impulse_count);
  }
  err = cudaGetLastError();
  const cudaError_t restore = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restore);
}

// K2b.
extern "C" int noise3d_sum_bwd(const void* p, const void* seed,
                               const void* kr, const void* qm, const void* g,
                               void* dp, void* part, int n, float m00,
                               float m11, float m22, int impulse_count,
                               int device, void* stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    noise3d_sum_bwd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)p, (const uint32_t*)seed, (const float*)kr,
        (const float*)qm, (const float*)g, (float*)dp, (float*)part, n, m00,
        m11, m22, impulse_count);
  }
  err = cudaGetLastError();
  const cudaError_t restore = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restore);
}
