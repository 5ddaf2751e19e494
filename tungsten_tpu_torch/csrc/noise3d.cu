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
// partials of K1's sum in p, kr and m6.  K2b (noise3d_sum_bwd_kernel)
// replaces ::_noise3d_sum_bwd, the same re-trace for K2: the partials in p,
// the per-point kr and qm and m6.  Each backward has two instances: the
// diagonal form (FULL false: m01 = m02 = m12 = 0, the partials in the
// diagonal of m6 alone) that every stationary and multi-resolution
// covariance without an anisoMtx gives, and the full symmetric form (FULL
// true: an anisoMtx in world space), whose partials take three more sums
// per point (of ab_x ab_y, ab_x ab_z and ab_y ab_z) and cover all of m6.
//
// What bounds them: integer ALU.  A point costs 27 xxhash32_4 cell keys and
// 27 * 4K xxhash32_2 variates -- about 330 hashes, thousands of 32-bit
// integer operations -- against 20 bytes moved for K1 (12 in, 4 seed, 4
// out) and 28 for K2 (its kr and qm).  K2 adds a per-point reciprocal and
// 27 * K multiplies by qm.  K1b hashes as K1 does and adds 12 float
// operations per impulse within reach, against 32 bytes (p, seed and the
// cotangent in; dp out; the parameters' partials are summed in the
// kernel); K2b likewise against 60 (kr and qm in too, 3 + 5 partials
// out).  The lever for later is data reuse: neighbouring points share most
// of their 27 cells and all of those cells' impulses, so a block could hash
// each cell once into shared memory instead of once per point.
//
// Design of K1, K2 and K2b: simple and exact first.  One thread per point,
// 256 threads per block, a masked tail and no padding; p is read as [N,3]
// AoS; m6 (and K1's kr) are passed by value; K is a runtime int.  Blocks
// keep no state between them.  The arithmetic follows the TPU kernels op
// for op: inv_r = 1 / kr, gx = px * inv_r, the cell index is
// (uint32)(int32)floor(g), keys are hashed in (z, y, x, seed) order,
// variates are (h >> 8) * 2^-24, K2 scales the finished quadratic form
// (q = qm * quad), and the sum runs dx, dy, dz, k.  K2b accumulates its
// nine sums per point in registers in the same order, with its loops kept
// rolled so that its SASS has K1's loop shape, and leaves the sum over
// points to the caller (no atomics).  Built without fast math and with
// -fmad=false, so float rounding follows the plain PyTorch twins
// (kernels/noise3d.py) operation for operation.
//
// Design of K1b, for the H100.  A warp runs an impulse's long path (its
// sign hash, q, expf and nine sums) when any of its 32 lanes has that
// impulse within reach: at K = 3 about 4 pi / 3 of a point's 27 impulses
// per index are, a share of 0.155, so a warp that branches on every
// impulse runs the long path on ~99.5% of them, six times the work within
// reach.  K1b splits the walk instead: every lane tests each impulse (its
// cell key, three position variates, the offset dd and r^2, the short
// path) and appends the ones within reach to a ring of K1B_RING entries of
// its own in shared memory, (ddx, ddy, ddz, the sign hash's first word),
// laid out [slot][thread] so that a warp's lanes hit distinct banks.  When
// a lane's ring could overflow in the next cell (__any_sync), and once at
// the end of the point, the warp drains: each lane works off its own ring
// in append order, so the warp pays the largest fill among its lanes (~19
// at K = 3) instead of every impulse.  Each point's terms are added in
// the (dx, dy, dz, k) order with the same operations as before, so dp
// stays bit-equal to the twin.  K = 3 (every scene's) is a template with
// the impulse loop unrolled; other counts take a runtime-K instantiation
// that checks the ring before each impulse.  The grid is one whole wave
// (the occupancy query's blocks per SM on every SM) that strides over the
// points; each thread adds its points' partials in (kr, m00, m11, m22) in
// float64, and grid_sum.cuh sums them over the grid in a fixed order (each
// block's threads, then the last block to take a ticket over the blocks),
// which then writes the four float32 sums: one launch, deterministic, no
// host sync.  Tensor cores,
// wgmma and TMA have nothing to do here: the function has no matrix
// product and moves 32 bytes a point.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "grid_sum.cuh"

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
// m12 = 0) the partials of the sum, scaled by the point's cotangent g, are
//   d/dp_i   = g (-2 m_ii S_i) kr / kr,
//   d/dkr    = g sum_i -2 m_ii (T_i - S_i p_i / kr),
//   d/dm_ii  = -g Q_i;
// dp [N, 3] is written per point, the other four are summed over points in
// float64 (K1B_PARTS) and written as float32 sums [4] of (kr, m00, m11,
// m22).  The full instance also sums P_ij = e ab_i ab_j (i < j), so that
// with c_ij = -2 m_ij
//   d/dp_i   = g (sum_j c_ij S_j) kr / kr,
//   d/dkr    = g (sum_i c_ii (T_i - S_i p_i / kr)
//                 + sum_i<j c_ij (2 P_ij / kr - (S_i p_j + S_j p_i) / kr)),
//   d/dm_ij  = -g 2 P_ij (i < j),
// and writes sums [7] of (kr, m00, m11, m22, m01, m02, m12) (K1B_FULL_PARTS).
// Chosen by timing ring sizes 8-24 at 2-4 blocks per SM on an H100: a ring
// that seldom fills before the end of a point drains about once a point,
// which beats a third block per SM.
constexpr int K1B_THREADS = 256;
constexpr int K1B_MIN_BLOCKS = 2;
constexpr int K1B_RING = 24;  // entries per thread: 96 KB a block
constexpr int K1B_PARTS = 4;
constexpr int K1B_FULL_PARTS = 7;

// The sums of one point: nine, and for the full form three cross sums.
struct Sums9 {
  float sx, sy, sz, tx, ty, tz, qx, qy, qz;
};
struct Sums12 : Sums9 {
  float pxy, pxz, pyz;
};
template <bool FULL>
using Sums = std::conditional_t<FULL, Sums12, Sums9>;

// The splat's quadratic form at offset ab, as K1 computes it.
template <bool FULL>
__device__ __forceinline__ float quad(float abx, float aby, float abz,
                                      float m00, float m11, float m22,
                                      float m01, float m02, float m12) {
  if (FULL) {
    return m00 * abx * abx + m11 * aby * aby + m22 * abz * abz
        + 2.0f * (m01 * abx * aby + m02 * abx * abz + m12 * aby * abz);
  }
  return m00 * abx * abx + m11 * aby * aby + m22 * abz * abz;
}

// Work off this lane's ring (its column `mine`, `count` entries, in append
// order) into s; every lane of the warp calls it together.
template <bool FULL>
__device__ __forceinline__ void k1b_drain(const float4* __restrict__ mine,
                                          int& count, float kr, float m00,
                                          float m11, float m22, float m01,
                                          float m02, float m12,
                                          Sums<FULL>& s) {
  const int most = __reduce_max_sync(FULL_MASK, count);
#pragma unroll 1
  for (int j = 0; j < most; ++j) {
    if (j < count) {
      const float4 e = mine[j * K1B_THREADS];
      // the rest of xxhash32_2(h, 4k + 3) from its first word
      const float uw = u01(final_mix(P4 * rotl17(__float_as_uint(e.w))));
      const float abx = kr * e.x;
      const float aby = kr * e.y;
      const float abz = kr * e.z;
      const float q = quad<FULL>(abx, aby, abz, m00, m11, m22, m01, m02, m12);
      const float w = uw < 0.5f ? -1.0f : 1.0f;
      const float t = w * expf(-q);
      const float ex = t * abx;
      const float ey = t * aby;
      const float ez = t * abz;
      s.sx = s.sx + ex;
      s.sy = s.sy + ey;
      s.sz = s.sz + ez;
      s.tx = s.tx + ex * e.x;
      s.ty = s.ty + ey * e.y;
      s.tz = s.tz + ez * e.z;
      s.qx = s.qx + ex * abx;
      s.qy = s.qy + ey * aby;
      s.qz = s.qz + ez * abz;
      if constexpr (FULL) {
        s.pxy = s.pxy + ex * aby;
        s.pxz = s.pxz + ex * abz;
        s.pyz = s.pyz + ey * abz;
      }
    }
  }
  count = 0;
}

// KC > 0: the impulse count, fixed at compile time; KC == 0: k_runtime.
// FULL: the full symmetric form (m01, m02 and m12 read; 7 sums), else the
// diagonal one (they are ignored; 4 sums).  The off-diagonal entries come
// last, and the diagonal instance keeps nine sums a point (Sums9) and its
// four accumulators, so that it compiles to the code of a kernel with no
// full form (the same SASS, register for register).
template <int KC, bool FULL>
__global__ void __launch_bounds__(K1B_THREADS, K1B_MIN_BLOCKS)
noise3d_sum_s_bwd_kernel(const float* __restrict__ p,
                         const uint32_t* __restrict__ seed,
                         const float* __restrict__ g, float* __restrict__ dp,
                         double* __restrict__ block_sums,
                         unsigned* __restrict__ ticket,
                         float* __restrict__ sums, int n, float kr,
                         float m00, float m11, float m22, int k_runtime,
                         float m01, float m02, float m12) {
  static_assert(K1B_RING >= KC, "a cell's impulses must fit the ring");
  constexpr int PARTS = FULL ? K1B_FULL_PARTS : K1B_PARTS;
  extern __shared__ float4 ring[];  // [K1B_RING][K1B_THREADS]
  const int impulses = KC > 0 ? KC : k_runtime;
  const int tid = threadIdx.x;
  float4* const mine = ring + tid;  // this thread's column
  const float inv_r = 1.0f / kr;
  const float c2x = -2.0f * m00;
  const float c2y = -2.0f * m11;
  const float c2z = -2.0f * m22;
  const float c2xy = -2.0f * m01;
  const float c2xz = -2.0f * m02;
  const float c2yz = -2.0f * m12;
  double acc[PARTS] = {};
  // block-uniform trip count: a warp's lanes past n walk with no point
  for (int base = blockIdx.x * K1B_THREADS; base < n;
       base += gridDim.x * K1B_THREADS) {
    const int i = base + tid;
    const bool live = i < n;
    const float px = live ? p[3 * i + 0] : 0.0f;
    const float py = live ? p[3 * i + 1] : 0.0f;
    const float pz = live ? p[3 * i + 2] : 0.0f;
    const uint32_t sd = live ? seed[i] : 0u;
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

    Sums<FULL> s = {};
    int count = 0;
    int dx = -1;
    int dy = -1;
    int dz = -1;
#pragma unroll 1
    for (int cell = 0; cell < 27; ++cell) {
      const uint32_t h = xxhash32_4(iz + (uint32_t)dz, iy + (uint32_t)dy,
                                    ix + (uint32_t)dx, sd) + 1u;
      const uint32_t hp = P5 + h * P3;
      const float qx = fx - (float)dx;
      const float qy = fy - (float)dy;
      const float qz = fz - (float)dz;
#pragma unroll
      for (int k = 0; k < impulses; ++k) {
        if (KC == 0 && __any_sync(FULL_MASK, count == K1B_RING)) {
          k1b_drain<FULL>(mine, count, kr, m00, m11, m22, m01, m02, m12, s);
        }
        const uint32_t c = 4u * (uint32_t)k;
        const float ux = u01(xxhash32_2(h, c));
        const float uy = u01(xxhash32_2(h, c + 1u));
        const float uz = u01(xxhash32_2(h, c + 2u));
        const float ddx = qx - ux;
        const float ddy = qy - uy;
        const float ddz = qz - uz;
        const float r2 = ddx * ddx + ddy * ddy + ddz * ddz;
        if (live && r2 < 1.0f) {
          mine[count * K1B_THREADS] =
              make_float4(ddx, ddy, ddz, __uint_as_float(c + 3u + hp));
          ++count;
        }
      }
      if (KC > 0 && __any_sync(FULL_MASK, count > K1B_RING - KC)) {
        k1b_drain<FULL>(mine, count, kr, m00, m11, m22, m01, m02, m12, s);
      }
      // the next cell in (dx, dy, dz) order
      const bool wrap_z = dz == 1;
      const bool wrap_y = wrap_z && dy == 1;
      dz = wrap_z ? -1 : dz + 1;
      dy = wrap_y ? -1 : (wrap_z ? dy + 1 : dy);
      dx = wrap_y ? dx + 1 : dx;
    }
    k1b_drain<FULL>(mine, count, kr, m00, m11, m22, m01, m02, m12, s);
    if constexpr (FULL) {
      if (live) {
        const float ct = g[i];
        dp[3 * i + 0] =
            ct * (c2x * s.sx + c2xy * s.sy + c2xz * s.sz) * kr * inv_r;
        dp[3 * i + 1] =
            ct * (c2xy * s.sx + c2y * s.sy + c2yz * s.sz) * kr * inv_r;
        dp[3 * i + 2] =
            ct * (c2xz * s.sx + c2yz * s.sy + c2z * s.sz) * kr * inv_r;
        const float dkr =
            ct * (c2x * (s.tx - s.sx * gx) + c2y * (s.ty - s.sy * gy)
                  + c2z * (s.tz - s.sz * gz)
                  + c2xy * (2.0f * s.pxy * inv_r - (s.sx * gy + s.sy * gx))
                  + c2xz * (2.0f * s.pxz * inv_r - (s.sx * gz + s.sz * gx))
                  + c2yz * (2.0f * s.pyz * inv_r - (s.sy * gz + s.sz * gy)));
        acc[0] += (double)dkr;
        acc[1] += (double)(-ct * s.qx);
        acc[2] += (double)(-ct * s.qy);
        acc[3] += (double)(-ct * s.qz);
        acc[PARTS - 3] += (double)(-ct * (2.0f * s.pxy));
        acc[PARTS - 2] += (double)(-ct * (2.0f * s.pxz));
        acc[PARTS - 1] += (double)(-ct * (2.0f * s.pyz));
      }
    } else {
      if (live) {
        const float ct = g[i];
        dp[3 * i + 0] = ct * (c2x * s.sx) * kr * inv_r;
        dp[3 * i + 1] = ct * (c2y * s.sy) * kr * inv_r;
        dp[3 * i + 2] = ct * (c2z * s.sz) * kr * inv_r;
        const float dkr = ct * (c2x * (s.tx - s.sx * gx)
                                + c2y * (s.ty - s.sy * gy)
                                + c2z * (s.tz - s.sz * gz));
        acc[0] += (double)dkr;
        acc[1] += (double)(-ct * s.qx);
        acc[2] += (double)(-ct * s.qy);
        acc[3] += (double)(-ct * s.qz);
      }
    }
  }

  if (grid_sum<PARTS, K1B_THREADS>(acc, block_sums, ticket)) {
#pragma unroll
    for (int j = 0; j < PARTS; ++j) sums[j] = (float)acc[j];
  }
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
// m11, m22).  The full instance (FULL) adds K1b's cross sums P_ij, with
// c2_ij = -2 qm m_ij: dp_i and dkr take K1b's full-form terms, d/dqm adds
// -g sum_i<j 2 m_ij P_ij, and d/dm_ij = -g qm 2 P_ij (i < j) are columns 5-7
// of per-point partials [N, 8].  dkr and dqm stay per point (the JAX
// package's are per lane); the caller sums the m partials over points.  As
// in K1b, m01, m02 and m12 come last and the diagonal instance's stores
// keep their order, so that it compiles to the code of a kernel with no
// full form.
template <bool FULL>
__global__ void __launch_bounds__(256)
noise3d_sum_bwd_kernel(const float* __restrict__ p,
                       const uint32_t* __restrict__ seed,
                       const float* __restrict__ kr_in,
                       const float* __restrict__ qm_in,
                       const float* __restrict__ g, float* __restrict__ dp,
                       float* __restrict__ part, int n, float m00, float m11,
                       float m22, int impulse_count, float m01, float m02,
                       float m12) {
  constexpr int PARTS = FULL ? 8 : 5;
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
  float pxy = 0.0f, pxz = 0.0f, pyz = 0.0f;
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
            const float q =
                qm * quad<FULL>(abx, aby, abz, m00, m11, m22, m01, m02, m12);
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
            if constexpr (FULL) {
              pxy = pxy + ex * aby;
              pxz = pxz + ex * abz;
              pyz = pyz + ey * abz;
            }
          }
        }
      }
    }
  }
  const float ct = g[i];
  const float c2x = -2.0f * qm * m00;
  const float c2y = -2.0f * qm * m11;
  const float c2z = -2.0f * qm * m22;
  if constexpr (!FULL) {
    dp[3 * i + 0] = ct * (c2x * sx) * kr * inv_r;
    dp[3 * i + 1] = ct * (c2y * sy) * kr * inv_r;
    dp[3 * i + 2] = ct * (c2z * sz) * kr * inv_r;
    part[PARTS * i + 0] = ct * (c2x * (tx - sx * gx) + c2y * (ty - sy * gy)
                                + c2z * (tz - sz * gz));
    part[PARTS * i + 1] = -ct * (m00 * qx2 + m11 * qy2 + m22 * qz2);
    const float cq = -ct * qm;
    part[PARTS * i + 2] = cq * qx2;
    part[PARTS * i + 3] = cq * qy2;
    part[PARTS * i + 4] = cq * qz2;
  } else {
    const float c2xy = -2.0f * qm * m01;
    const float c2xz = -2.0f * qm * m02;
    const float c2yz = -2.0f * qm * m12;
    dp[3 * i + 0] = ct * (c2x * sx + c2xy * sy + c2xz * sz) * kr * inv_r;
    dp[3 * i + 1] = ct * (c2xy * sx + c2y * sy + c2yz * sz) * kr * inv_r;
    dp[3 * i + 2] = ct * (c2xz * sx + c2yz * sy + c2z * sz) * kr * inv_r;
    part[PARTS * i + 0] =
        ct * (c2x * (tx - sx * gx) + c2y * (ty - sy * gy)
              + c2z * (tz - sz * gz)
              + c2xy * (2.0f * pxy * inv_r - (sx * gy + sy * gx))
              + c2xz * (2.0f * pxz * inv_r - (sx * gz + sz * gx))
              + c2yz * (2.0f * pyz * inv_r - (sy * gz + sz * gy)));
    part[PARTS * i + 1] =
        -ct * (m00 * qx2 + m11 * qy2 + m22 * qz2
               + 2.0f * (m01 * pxy + m02 * pxz + m12 * pyz));
    const float cq = -ct * qm;
    part[PARTS * i + 2] = cq * qx2;
    part[PARTS * i + 3] = cq * qy2;
    part[PARTS * i + 4] = cq * qz2;
    part[PARTS * i + 5] = cq * (2.0f * pxy);
    part[PARTS * i + 6] = cq * (2.0f * pxz);
    part[PARTS * i + 7] = cq * (2.0f * pyz);
  }
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

// K1b's instantiation for an impulse count and form (full != 0: the full
// symmetric form), allowed its ring of dynamic shared memory (above the
// default 48 KB).
using K1bKernel = void (*)(const float*, const uint32_t*, const float*,
                           float*, double*, unsigned*, float*, int, float,
                           float, float, float, int, float, float, float);
constexpr size_t K1B_SMEM = sizeof(float4) * K1B_RING * K1B_THREADS;

static cudaError_t k1b_kernel(int impulse_count, int full,
                              K1bKernel* kernel) {
  if (full) {
    *kernel = impulse_count == 3 ? noise3d_sum_s_bwd_kernel<3, true>
                                 : noise3d_sum_s_bwd_kernel<0, true>;
  } else {
    *kernel = impulse_count == 3 ? noise3d_sum_s_bwd_kernel<3, false>
                                 : noise3d_sum_s_bwd_kernel<0, false>;
  }
  return cudaFuncSetAttribute(*kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)K1B_SMEM);
}

// K1b's grid for n points on `device` (current on entry and exit): one
// whole wave, the occupancy query's blocks per SM on every SM, or fewer
// when n fills fewer blocks; at least 1.
static cudaError_t k1b_grid(int n, int impulse_count, int full, int device,
                            int* blocks) {
  K1bKernel kernel;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = k1b_kernel(impulse_count, full, &kernel);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, K1B_THREADS, K1B_SMEM);
  }
  const int need = (n + K1B_THREADS - 1) / K1B_THREADS;
  *blocks = need < sms * per_sm ? need : sms * per_sm;
  if (*blocks < 1) *blocks = 1;
  return err;
}

extern "C" int noise3d_sum_s_bwd_grid(int n, int impulse_count, int full,
                                      int device, int* blocks) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = k1b_grid(n, impulse_count, full, device, blocks);
  const cudaError_t restore = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restore);
}

// K1b on `blocks` blocks (noise3d_sum_s_bwd_grid with the same `full`):
// dp [n, 3], and sums [4] (full: [7]) through block_sums [blocks, 4] (full:
// [blocks, 7]; float64 scratch) and the ticket, a device word at 0 that the
// launch leaves at 0.
extern "C" int noise3d_sum_s_bwd(const void* p, const void* seed,
                                 const void* g, void* dp, void* block_sums,
                                 void* ticket, void* sums, int n, int blocks,
                                 float kr, float m00, float m11, float m22,
                                 float m01, float m02, float m12, int full,
                                 int impulse_count, int device,
                                 void* stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  K1bKernel kernel;
  err = k1b_kernel(impulse_count, full, &kernel);
  if (err == cudaSuccess) {
    kernel<<<blocks, K1B_THREADS, K1B_SMEM, (cudaStream_t)stream>>>(
        (const float*)p, (const uint32_t*)seed, (const float*)g, (float*)dp,
        (double*)block_sums, (unsigned*)ticket, (float*)sums, n, kr, m00,
        m11, m22, impulse_count, m01, m02, m12);
    err = cudaGetLastError();
  }
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

// K2b: part [n, 5], or [n, 8] for the full form (full != 0).
extern "C" int noise3d_sum_bwd(const void* p, const void* seed,
                               const void* kr, const void* qm, const void* g,
                               void* dp, void* part, int n, float m00,
                               float m11, float m22, float m01, float m02,
                               float m12, int full, int impulse_count,
                               int device, void* stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    const auto kernel = full ? noise3d_sum_bwd_kernel<true>
                             : noise3d_sum_bwd_kernel<false>;
    kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)p, (const uint32_t*)seed, (const float*)kr,
        (const float*)qm, (const float*)g, (float*)dp, (float*)part, n, m00,
        m11, m22, impulse_count, m01, m02, m12);
  }
  err = cudaGetLastError();
  const cudaError_t restore = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restore);
}
