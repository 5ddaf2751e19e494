// K5 and K4: the weight-space search of each ray over its own random
// Fourier feature (RFF) realization, from the ray's stream keys to the
// first crossing, in one launch.
//
// K5 (ws_march) replaces tungsten_tpu/ops/ws_trace_pallas.py::_march_kernel
// (launched by _march_chunk, re-dispatched by fixed_march_batch): fixed
// steps of
//   f(tc) = scale * sum_i amp_i cos(a_i + slope_i tc) + mean(tc),
//   tc = near + step * (u_jitter + k),
// until the sign flips against sign0 = sign f(near) (the first step after
// an interior scatter, `absorb`, sets sign0 and cannot flip) or tc reaches
// far, at most max_steps steps; then 6 Illinois false-position steps inside
// [t_hi - step, t_hi] unless the caller asks for none.
// K4 (ws_trace) replaces the same file's _trace_kernel (launched by
// _trace_chunk, re-dispatched by sphere_trace_batch): adaptive range-bound
// steps over [t, t + step], bounding each basis term by the exact cos
// interval of its phase range and the mean by its midpoint value +-
// Lipschitz * half-length; the step grows x1.6 while the bound excludes
// zero and halves otherwise, and a hit is declared when a sign-ambiguous
// step is at most min_step; at most max_iters iterations.
//
// Each ray's basis is synthesised here from its two stream keys, with the
// counters and operation order of the plain PyTorch path
// (ops/weight_space.py, ops/covariance.py, utils/rng.py) in native uint32.
// With g_i = (normal2(key, 3i).{cos, sin}, normal2(key, 3i+1).cos), each
// covariance draws its spectral sample omega_i in its own way, one
// template instance per covariance (kCov, the tags of kernels/ws_trace.py):
//   kSE: g_i / l * sqrt(aniso);
//   kRQ: g_i / l_eff with 1 / l_eff^2 = Gamma(a) / (a l^2), Gamma by
//        Marsaglia-Tsang with four proposals (proposal k: the normal
//        normal2(key, 16 + 16i + k).cos and the uniform
//        uniform(key, 97 + 16i + k); the first accepted, else the mode);
//   kMatern: g_i sqrt(2 nu / chi2) / l, chi2 = -2 nu log1p(-uniform(key,
//        5i + 1)) floored at 1e-6;
//   kGabor: g_i (both Gabor covariances);
//   kPeriodic: g_i / max(|g_i|, 1e-9) * 2 pi / period;
//   kThinPlate: g_i / R.
// (The counters overlap those of g_i and of the offsets as the JAX
// package's draws overlap them.)  Then
//   offset_i = uniform(key, 1000000 + i) * 2 pi;
//   w_i = normal2(key2, 2000000 + i/2).{cos if i even, sin if odd};
//   freq_i = sqrt(max(omega_i . omega_i, 1e-20)), dir_i = omega_i / freq_i;
//   a_i = freq_i (dir_i . ro) + offset_i, slope_i = freq_i (dir_i . rd),
//   amp_i = w_i sqrt(2/n).
// At the end the value and gradient of the realization at ro + t rd are
// computed as ws.evaluate / ws.evaluate_gradient compute them (projection of
// dir_i onto the point), from a second synthesis of the basis.
//
// What bounds them: float work.  Per basis function and step K5 does a
// precise cosf and 4 other flops, K4 2 cosf, 4 divides by 2 pi (3 ops
// each), 4 floors and ~24 other flops; the synthesis costs ~7 xxhash32
// (integer) and 3 log1pf, 4 cosf/sinf, 6 divides and ~40 other flops per
// basis function, twice per ray (the SE's; RQ's adds 12 xxhash32, 4 log1pf,
// 4 cosf, 8 logf, 3 divides and ~40 flops, Matern's 1 xxhash32, 1 log1pf,
// 2 divides and a sqrtf).  Device memory sees only the per-ray
// inputs and the [R, 8] output.
//
// Design: one warp per ray; warps take rays from a counter, so a warp whose
// ray ends early starts the next instead of idling beside a long one, and
// the grid holds as many 64-thread blocks as the card runs at once.  Lane j
// synthesises basis functions j, j+32, ... and keeps the first kTile = 32
// of them as (a, slope, amp) in its column of shared memory for the whole
// search: 12 KB a warp at n = 1024, ~60 registers a lane.
// (Holding them in registers instead, 96 a lane, needs the step's 32 terms
// unrolled, each with a precise cosf and its slow path inline; on the H100
// that ran 3.8-4.9x slower than this tile, see PERF.md.)  Basis functions
// past 32 kTile (n > 1024) are synthesised again at every evaluation, which
// is correct and slower.  Padding entries (j >= n) hold amp = a = slope = 0 and
// add an exact 0.  A __shfl_xor_sync butterfly sums the lanes, so every lane
// holds the same bits and the warp takes one branch; the step loop, the
// refinement and the evaluation run without leaving the kernel.  Precise
// cosf, sinf, log1pf and sqrtf, IEEE-rounded divides, no fast math, built
// with -fmad=false, so each term rounds as in the plain PyTorch twins
// (kernels/ws_trace.py); only the order of the n-term sums differs, and
// beside the SE they run in float64 and round once, so they agree too.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kLanes = 32;  // lanes per ray: one warp
constexpr int kWarpsPerBlock = 2;
// basis functions a lane keeps in the tile: kLanes * kTile = 1024 a warp;
// any smaller n pads with entries that add an exact 0
constexpr int kTile = 32;
constexpr float kTwoPi = 6.2831855f;  // float32(2 pi)
constexpr float kPi = 3.1415927f;     // float32(pi)
constexpr float kInvTwoPi = 1.0f / kTwoPi;  // rounded to nearest
constexpr uint32_t kP2 = 2246822519u;
constexpr uint32_t kP3 = 3266489917u;
constexpr uint32_t kP4 = 668265263u;
constexpr uint32_t kP5 = 374761393u;

// params: the medium's constants, in this order
enum {
  kL,         // covariance length scale l
  kSa0,       // sqrt(aniso), per axis
  kSa1,
  kSa2,
  kScale,     // sqrt(cov(0, 0))
  kSqrt2n,    // sqrt(2 / n) as float32 rounds it
  kCx,        // spherical mean: center, radius
  kCy,
  kCz,
  kRadius,
  kMOff,      // homogeneous mean: offset
  kLipM,      // the mean's Lipschitz constant (K4)
  kMinStep,   // K4's shortest step
  kCovA,      // the covariance's constant: RQ's a, Matern's nu, Periodic's
              // period, ThinPlate's R
  kNumParams
};

// the covariance tags (kernels/ws_trace.py COV_TAGS)
enum { kSE, kRQ, kMatern, kGabor, kPeriodic, kThinPlate };

// per-ray output columns
enum { kOutHit, kOutT, kOutSign, kOutVal, kOutGx, kOutGy, kOutGz, kOutSteps };

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = kLanes / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t rotl17(uint32_t x) {
  return (x << 17) | (x >> 15);
}

// xxhash32 of the two words (x, y), as utils/rng.py::xxhash32_2
__device__ __forceinline__ uint32_t xxhash32_2(uint32_t x, uint32_t y) {
  uint32_t h = y + kP5 + x * kP3;
  h = rotl17(h) * kP4;
  h = (h ^ (h >> 15)) * kP2;
  h = (h ^ (h >> 13)) * kP3;
  return h ^ (h >> 16);
}

__device__ __forceinline__ float uniform(uint32_t key, uint32_t ctr) {
  return (float)(xxhash32_2(key, ctr) >> 8) * (1.0f / 16777216.0f);
}

// radius and angle of the Box-Muller pair normal2(key, c): the variates are
// r cos(angle) and r sin(angle)
__device__ __forceinline__ void box_muller(uint32_t key, uint32_t c, float& r,
                                           float& angle) {
  const uint32_t c2 = 2u * c;
  const float u1 = uniform(key, c2);
  const float u2 = uniform(key, c2 + 1u);
  r = sqrtf(-2.0f * log1pf(-u1));
  angle = kTwoPi * u2;
}

struct Ray {
  uint32_t key, key2;
  float ox, oy, oz, dx, dy, dz;
};

struct BasisFn {
  float dx, dy, dz, freq, offset, w;
};

// the first of the Box-Muller pair normal2(key, c)
__device__ __forceinline__ float normal_cos(uint32_t key, uint32_t c) {
  float r, angle;
  box_muller(key, c, r, angle);
  return r * cosf(angle);
}

// RQ's effective length l_eff = 1 / sqrt(tau), tau = Gamma(a) (1 / l^2) / a
// by Marsaglia-Tsang's squeeze over four proposals
__device__ __forceinline__ float rq_length(uint32_t key, uint32_t i,
                                               const float* __restrict__ prm) {
  const float shape = prm[kCovA];
  const float d = shape - 1.0f / 3.0f;
  const float c = 1.0f / sqrtf(9.0f * d);
  float val = 0.0f;
  bool accepted = false;
  for (uint32_t k = 0; k < 4u; ++k) {
    const float n = normal_cos(key, 16u + 16u * i + k);
    const float u = uniform(key, 97u + 16u * i + k);
    const float x = 1.0f + c * n;
    const float v = x * (x * x);
    const float vf = fmaxf(v, 1e-9f);
    const bool ok =
        v > 0.0f && logf(u) < 0.5f * (n * n) + d - d * v + d * logf(vf);
    const float cand = d * vf;
    if (k == 0u || !accepted) val = cand;
    accepted = accepted || ok;
  }
  if (!accepted) val = d;
  const float l = prm[kL];
  const float mean_rate = 1.0f / (l * l);
  const float tau = val * (mean_rate / shape);
  return 1.0f / sqrtf(tau);
}

// the spectral sample omega of basis function i, drawn as covariance kCov
// draws it
template <int kCov>
__device__ __forceinline__ void spectral(const Ray& ray, uint32_t i,
                                         const float* __restrict__ prm,
                                         float& o0, float& o1, float& o2) {
  float r, angle;
  box_muller(ray.key, 3u * i, r, angle);
  const float g0 = r * cosf(angle);
  const float g1 = r * sinf(angle);
  const float g2 = normal_cos(ray.key, 3u * i + 1u);
  if constexpr (kCov == kSE) {
    const float l = prm[kL];
    o0 = g0 / l * prm[kSa0];
    o1 = g1 / l * prm[kSa1];
    o2 = g2 / l * prm[kSa2];
  } else if constexpr (kCov == kRQ) {
    const float l_eff = rq_length(ray.key, i, prm);
    o0 = g0 / l_eff;
    o1 = g1 / l_eff;
    o2 = g2 / l_eff;
  } else if constexpr (kCov == kMatern) {
    const float nu = prm[kCovA], l = prm[kL];
    const float u = uniform(ray.key, 5u * i + 1u);
    const float chi2 = -2.0f * nu * log1pf(-u);
    const float s = sqrtf(2.0f * nu / fmaxf(chi2, 1e-6f));
    o0 = g0 * s / l;
    o1 = g1 * s / l;
    o2 = g2 * s / l;
  } else if constexpr (kCov == kGabor) {
    o0 = g0;
    o1 = g1;
    o2 = g2;
  } else if constexpr (kCov == kPeriodic) {
    const float norm = fmaxf(sqrtf(g0 * g0 + g1 * g1 + g2 * g2), 1e-9f);
    const float period = prm[kCovA];
    o0 = g0 / norm * 2.0f * kPi / period;
    o1 = g1 / norm * 2.0f * kPi / period;
    o2 = g2 / norm * 2.0f * kPi / period;
  } else {
    static_assert(kCov == kThinPlate, "unknown covariance tag");
    const float R = prm[kCovA];
    o0 = g0 / R;
    o1 = g1 / R;
    o2 = g2 / R;
  }
}

// basis function i of the ray's realization
template <int kCov>
__device__ __forceinline__ BasisFn synth(const Ray& ray, uint32_t i,
                                         const float* __restrict__ prm) {
  float o0, o1, o2, r, angle;
  spectral<kCov>(ray, i, prm, o0, o1, o2);
  BasisFn b;
  b.freq = sqrtf(fmaxf(o0 * o0 + o1 * o1 + o2 * o2, 1e-20f));
  b.dx = o0 / b.freq;
  b.dy = o1 / b.freq;
  b.dz = o2 / b.freq;
  b.offset = uniform(ray.key, 1000000u + i) * kTwoPi;
  box_muller(ray.key2, 2000000u + i / 2u, r, angle);
  b.w = r * ((i & 1u) ? sinf(angle) : cosf(angle));
  return b;
}

// the affine phase a + slope t of basis function b along the ray, and amp
__device__ __forceinline__ void hoist(const BasisFn& b, const Ray& ray,
                                      const float* __restrict__ prm, float& a,
                                      float& slope, float& amp) {
  a = b.freq * (b.dx * ray.ox + b.dy * ray.oy + b.dz * ray.oz) + b.offset;
  slope = b.freq * (b.dx * ray.dx + b.dy * ray.dy + b.dz * ray.dz);
  amp = b.w * prm[kSqrt2n];
}

// w cos(phase) of basis function b at the point p, as ws.evaluate's terms
__device__ __forceinline__ float term_at(const BasisFn& b, float px, float py,
                                         float pz) {
  return b.w * cosf((b.dx * px + b.dy * py + b.dz * pz) * b.freq + b.offset);
}

// the mean along the ray: sqrt(A + t (2B + t)) - radius with A = |ro - c|^2,
// B = (ro - c) . rd for a spherical mean, the offset for a homogeneous one
__device__ __forceinline__ float mean_at(bool spherical, float A, float B,
                                         float t, const float* prm) {
  if (!spherical) return prm[kMOff];
  const float d2 = A + t * (2.0f * B + t);
  return sqrtf(fmaxf(d2, 0.0f)) - prm[kRadius];
}

// the mean and its gradient at the point p, as means.py computes them
__device__ __forceinline__ float mean_point(bool spherical, float px, float py,
                                            float pz, const float* prm,
                                            float g[3]) {
  if (!spherical) {
    g[0] = g[1] = g[2] = 0.0f;
    return prm[kMOff];
  }
  const float x = px - prm[kCx], y = py - prm[kCy], z = pz - prm[kCz];
  const float len = sqrtf(fmaxf(x * x + y * y + z * z, 1e-24f));
  if (len > 1e-20f) {
    g[0] = x / len;
    g[1] = y / len;
    g[2] = z / len;
  } else {
    g[0] = 1.0f;
    g[1] = g[2] = 0.0f;
  }
  return len - prm[kRadius];
}

// the type K5's sums over the basis run in: float for the squared
// exponential, float64 beside it (rounded once to float32 after the warp's
// sum), so that two orders of the sum round alike: a heavy-tailed draw
// (RQ, Matern) puts frequencies up to ~1e4 in the sum, where an ulp of f
// moves the refined crossing, and the end point's gradient with it, by
// more than the checks allow
template <int kCov>
using SumT = typename std::conditional<kCov == kSE, float, double>::type;

// This lane's share of sum_i amp_i cos(a_i + slope_i t): the tile (this
// lane's column: a, slope and amp of kTile functions, kLanes floats apart),
// then the basis functions past it, synthesised again.
template <int kCov>
__device__ __forceinline__ SumT<kCov> lane_sum(const float* __restrict__ tile,
                                               float t, const Ray& ray, int n,
                                               int lane,
                                               const float* __restrict__ prm) {
  SumT<kCov> acc = 0;
#pragma unroll 2
  for (int i = 0; i < kTile; ++i) {
    const float* c = tile + i * kLanes;
    acc += (SumT<kCov>)(c[2 * kTile * kLanes] *
                        cosf(c[0] + c[kTile * kLanes] * t));
  }
  for (int j = lane + kLanes * kTile; j < n; j += kLanes) {
    float a, s, m;
    hoist(synth<kCov>(ray, (uint32_t)j, prm), ray, prm, a, s, m);
    acc += (SumT<kCov>)(m * cosf(a + s * t));
  }
  return acc;
}

// f at t along the ray, in the hoisted form of the twin's value_of
template <int kCov>
__device__ __forceinline__ float value_at(const float* __restrict__ tile,
                                          float t, const Ray& ray, int n,
                                          int lane,
                                          const float* __restrict__ prm,
                                          bool spherical, float A, float B) {
  const float nsum =
      (float)warp_sum(lane_sum<kCov>(tile, t, ray, n, lane, prm));
  return prm[kScale] * nsum + mean_at(spherical, A, B, t, prm);
}

// x / float32(2 pi), rounded as IEEE division rounds it: the product with
// the rounded reciprocal, then one exact remainder and its correction
// (Markstein), without the divide's slow-path branch.
__device__ __forceinline__ float div_two_pi(float x) {
  const float q = x * kInvTwoPi;
  return fmaf(fmaf(-q, kTwoPi, x), kInvTwoPi, q);
}

// The cos-interval bound of one basis term over the phases [th0, th1]:
// adds its least and greatest value to lo and hi.
__device__ __forceinline__ void bound_term(float th0, float th1, float w,
                                           float& lo_acc, float& hi_acc) {
  const float lo = fminf(th0, th1);
  const float hi = fmaxf(th0, th1);
  const float c_lo = cosf(lo);
  const float c_hi = cosf(hi);
  float cmin = fminf(c_lo, c_hi);
  float cmax = fmaxf(c_lo, c_hi);
  const bool k_even = floorf(div_two_pi(hi)) - floorf(div_two_pi(lo)) >= 1.0f;
  const bool k_odd = floorf(div_two_pi(hi - kPi)) -
                         floorf(div_two_pi(lo - kPi)) >= 1.0f;
  const bool wide = (hi - lo) >= kTwoPi;
  if (k_even || wide) cmax = 1.0f;
  if (k_odd || wide) cmin = -1.0f;
  lo_acc += fminf(w * cmin, w * cmax);
  hi_acc += fmaxf(w * cmin, w * cmax);
}

// Synthesises this lane's column of the tile; padding entries are 0.  With
// kF0 it also returns this lane's share of sum_i w_i cos(phase_i(p)) at the
// point p, over all n basis functions (K4's f0).
template <int kCov, bool kF0>
__device__ __forceinline__ float load_tile(float* __restrict__ tile,
                                           const Ray& ray, int n, int lane,
                                           const float* __restrict__ prm,
                                           float px, float py, float pz) {
  float s0 = 0.0f;
#pragma unroll 1
  for (int i = 0; i < kTile; ++i) {
    const int j = lane + kLanes * i;
    float a = 0.0f, s = 0.0f, m = 0.0f;
    if (j < n) {
      const BasisFn b = synth<kCov>(ray, (uint32_t)j, prm);
      if (kF0) s0 += term_at(b, px, py, pz);
      hoist(b, ray, prm, a, s, m);
    }
    tile[i * kLanes] = a;
    tile[(kTile + i) * kLanes] = s;
    tile[(2 * kTile + i) * kLanes] = m;
  }
  if (kF0)
    for (int j = lane + kLanes * kTile; j < n; j += kLanes)
      s0 += term_at(synth<kCov>(ray, (uint32_t)j, prm), px, py, pz);
  return s0;
}

// The realization's value and gradient at ro + t rd, as ws.evaluate and
// ws.evaluate_gradient compute them; lane 0 writes them to o.  The sums
// over the basis run in SumT (float64 beside the squared exponential: a
// heavy-tailed draw holds gradient terms a thousand times the sum, and
// float32 sums in two orders would differ by more than the checks allow).
template <int kCov>
__device__ __forceinline__ void evaluate(const Ray& ray, float t, int n,
                                         int lane, const float* prm,
                                         bool spherical, float* o) {
  using Acc = SumT<kCov>;
  const float px = ray.ox + t * ray.dx;
  const float py = ray.oy + t * ray.dy;
  const float pz = ray.oz + t * ray.dz;
  Acc s = 0, g0 = 0, g1 = 0, g2 = 0;
  for (int j = lane; j < n; j += kLanes) {
    const BasisFn b = synth<kCov>(ray, (uint32_t)j, prm);
    const float phase = (b.dx * px + b.dy * py + b.dz * pz) * b.freq + b.offset;
    s += (Acc)(b.w * cosf(phase));
    const float coeff = -sinf(phase) * b.freq * b.w;
    g0 += (Acc)(coeff * b.dx);
    g1 += (Acc)(coeff * b.dy);
    g2 += (Acc)(coeff * b.dz);
  }
  const float sf = (float)warp_sum(s);
  const float gf0 = (float)warp_sum(g0);
  const float gf1 = (float)warp_sum(g1);
  const float gf2 = (float)warp_sum(g2);
  float mg[3];
  const float m = mean_point(spherical, px, py, pz, prm, mg);
  const float scale = prm[kScale], k = prm[kSqrt2n];
  if (lane == 0) {
    o[kOutVal] = scale * (sf * k) + m;
    o[kOutGx] = scale * (gf0 * k) + mg[0];
    o[kOutGy] = scale * (gf1 * k) + mg[1];
    o[kOutGz] = scale * (gf2 * k) + mg[2];
  }
}

__device__ __forceinline__ Ray load_ray(const int32_t* __restrict__ keys,
                                        const float* __restrict__ ro,
                                        const float* __restrict__ rd,
                                        int64_t r) {
  Ray ray;
  ray.key = (uint32_t)keys[2 * r];
  ray.key2 = (uint32_t)keys[2 * r + 1];
  ray.ox = ro[3 * r];
  ray.oy = ro[3 * r + 1];
  ray.oz = ro[3 * r + 2];
  ray.dx = rd[3 * r];
  ray.dy = rd[3 * r + 1];
  ray.dz = rd[3 * r + 2];
  return ray;
}

// A = |ro - c|^2 and B = (ro - c) . rd of the spherical mean
__device__ __forceinline__ void mean_consts(const Ray& ray, const float* prm,
                                            float& A, float& B) {
  const float x = ray.ox - prm[kCx], y = ray.oy - prm[kCy],
              z = ray.oz - prm[kCz];
  A = x * x + y * y + z * z;
  B = x * ray.dx + y * ray.dy + z * ray.dz;
}

// K5's search of ray r by one warp
template <int kCov>
__device__ __forceinline__ void march_ray(
    int64_t r, int lane, float* __restrict__ tile,
    const int32_t* __restrict__ keys,
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ near, const float* __restrict__ far,
    const float* __restrict__ step, const float* __restrict__ u_jitter,
    const uint8_t* __restrict__ absorb, const float* __restrict__ prm,
    float* __restrict__ out, int n, int max_steps, int spherical, int refine,
    int with_eval) {
  const Ray ray = load_ray(keys, ro, rd, r);
  const bool sph = spherical != 0;
  float A = 0.0f, B = 0.0f;
  if (sph) mean_consts(ray, prm, A, B);
  load_tile<kCov, false>(tile, ray, n, lane, prm, 0.0f, 0.0f, 0.0f);

  const float t_near = near[r], t_far = far[r], dt = step[r];
  const bool absorbs = absorb[r] != 0;
  const float f0 = value_at<kCov>(tile, t_near, ray, n, lane, prm, sph, A, B);
  float sign0 = f0 < 0.0f ? -1.0f : 1.0f;
  const float t1 = t_near + dt * u_jitter[r];
  float k = 0.0f, t_hi = t_far, f_lo = f0, f_hi = 0.0f, f_prev = f0;
  bool crossed = false;
  int steps = 0;
  for (int it = 0; it < max_steps; ++it) {
    const bool first_abs = absorbs && k < 0.5f;
    const float tc = t1 + dt * k;
    const float f = value_at<kCov>(tile, tc, ray, n, lane, prm, sph, A, B);
    ++steps;
    const float sgn = f < 0.0f ? -1.0f : 1.0f;
    if (first_abs) sign0 = sgn;
    const bool flip = (sgn != sign0) && (tc < t_far) && !first_abs;
    if (flip) {
      crossed = true;
      t_hi = tc;
      f_hi = f;
      f_lo = f_prev;
    }
    if (flip || tc >= t_far) break;
    k += 1.0f;
    f_prev = f;
  }

  float t = crossed ? t_hi : t_far;
  if (crossed && refine) {  // Illinois false position in [t_hi - step, t_hi]
    float lo = fmaxf(t_hi - dt, t_near), hi = t_hi, flo = f_lo, fhi = f_hi;
    for (int i = 0; i < 6; ++i) {
      const float denom = flo - fhi;
      const bool tiny = fabsf(denom) < 1e-30f;
      const float mid_s = lo + flo * (hi - lo) / (tiny ? 1.0f : denom);
      const float mid =
          (tiny || mid_s <= lo || mid_s >= hi) ? 0.5f * (lo + hi) : mid_s;
      const float fm = value_at<kCov>(tile, mid, ray, n, lane, prm, sph, A, B);
      if ((fm < 0.0f ? -1.0f : 1.0f) == sign0) {
        lo = mid;
        flo = fm;
        fhi = fhi * 0.5f;
      } else {
        hi = mid;
        fhi = fm;
        flo = flo * 0.5f;
      }
    }
    t = hi;
  }

  float* o = out + r * 8;
  if (with_eval) evaluate<kCov>(ray, t, n, lane, prm, sph, o);
  if (lane == 0) {
    o[kOutHit] = crossed ? 1.0f : 0.0f;
    o[kOutT] = t;
    o[kOutSign] = sign0;
    o[kOutSteps] = (float)steps;
    if (!with_eval) o[kOutVal] = o[kOutGx] = o[kOutGy] = o[kOutGz] = 0.0f;
  }
}

// K4's search of ray r by one warp
template <int kCov>
__device__ __forceinline__ void trace_ray(
    int64_t r, int lane, float* __restrict__ tile,
    const int32_t* __restrict__ keys,
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ near, const float* __restrict__ far,
    const float* __restrict__ prm, float* __restrict__ out, int n,
    int max_iters, int spherical, int with_eval) {
  const Ray ray = load_ray(keys, ro, rd, r);
  const bool sph = spherical != 0;
  float A = 0.0f, B = 0.0f;
  if (sph) mean_consts(ray, prm, A, B);
  // sign0 from f at near in the evaluate form, as the twin's trace_inputs
  const float t_near = near[r], t_far = far[r];
  const float px = ray.ox + t_near * ray.dx;
  const float py = ray.oy + t_near * ray.dy;
  const float pz = ray.oz + t_near * ray.dz;
  const float s0 = load_tile<kCov, true>(tile, ray, n, lane, prm, px, py, pz);
  float mg[3];
  const float f0 = prm[kScale] * (warp_sum(s0) * prm[kSqrt2n]) +
                   mean_point(sph, px, py, pz, prm, mg);
  const float sign0 = f0 < 0.0f ? -1.0f : 1.0f;

  const float min_step = prm[kMinStep], lip_m = prm[kLipM];
  const float scale = prm[kScale];
  float t = t_near, dt = fmaxf((t_far - t_near) * 0.05f, min_step);
  bool hit = false;
  int iters = 0;
  for (int it = 0; it < max_iters; ++it) {
    const float t_end = t + dt;
    float acc_lo = 0.0f, acc_hi = 0.0f;
#pragma unroll 2
    for (int i = 0; i < kTile; ++i) {
      const float* c = tile + i * kLanes;
      bound_term(c[0] + c[kTile * kLanes] * t,
                 c[0] + c[kTile * kLanes] * t_end, c[2 * kTile * kLanes],
                 acc_lo, acc_hi);
    }
    for (int j = lane + kLanes * kTile; j < n; j += kLanes) {
      float a, s, m;
      hoist(synth<kCov>(ray, (uint32_t)j, prm), ray, prm, a, s, m);
      bound_term(a + s * t, a + s * t_end, m, acc_lo, acc_hi);
    }
    const float n_lo = scale * warp_sum(acc_lo);
    const float n_hi = scale * warp_sum(acc_hi);
    const float m_mid = mean_at(sph, A, B, t + 0.5f * dt, prm);
    const float half = 0.5f * dt * lip_m;
    const float lo_b = n_lo + m_mid - half;
    const float hi_b = n_hi + m_mid + half;
    const bool no_cross = sign0 > 0.0f ? lo_b > 0.0f : hi_b < 0.0f;
    const bool converged = !no_cross && dt <= min_step;
    const float t_new = no_cross ? t + dt : t;
    float dt_new = no_cross ? dt * 1.6f : dt * 0.5f;
    dt_new = fmaxf(dt_new, min_step * 0.5f);
    const bool exited = t_new >= t_far;
    dt_new = fminf(dt_new, t_far - t_new + 1e-6f);
    t = t_new;
    dt = dt_new;
    ++iters;
    if (converged) hit = true;
    if (converged || exited) break;
  }

  const float t_out = hit ? t : t_far;
  float* o = out + r * 8;
  if (with_eval) evaluate<kCov>(ray, t_out, n, lane, prm, sph, o);
  if (lane == 0) {
    o[kOutHit] = hit ? 1.0f : 0.0f;
    o[kOutT] = t_out;
    o[kOutSign] = sign0;
    o[kOutSteps] = (float)iters;
    if (!with_eval) o[kOutVal] = o[kOutGx] = o[kOutGy] = o[kOutGz] = 0.0f;
  }
}

// The next ray for this warp: lane 0 takes it from the counter, so a warp
// whose ray ends early starts another instead of idling beside a long one.
__device__ __forceinline__ int64_t next_ray(int* __restrict__ next, int lane) {
  int r = 0;
  if (lane == 0) r = atomicAdd(next, 1);
  return __shfl_sync(0xffffffffu, r, 0);
}

template <int kCov>
__global__ void __launch_bounds__(kLanes * kWarpsPerBlock)
ws_march_kernel(int* __restrict__ next, int R,
                const int32_t* __restrict__ keys, const float* __restrict__ ro,
                const float* __restrict__ rd, const float* __restrict__ near,
                const float* __restrict__ far, const float* __restrict__ step,
                const float* __restrict__ u_jitter,
                const uint8_t* __restrict__ absorb,
                const float* __restrict__ prm, float* __restrict__ out, int n,
                int max_steps, int spherical, int refine, int with_eval) {
  const int lane = threadIdx.x % kLanes;
  __shared__ float tiles[kWarpsPerBlock][3 * kTile * kLanes];
  float* tile = tiles[threadIdx.x / kLanes] + lane;
  for (int64_t r = next_ray(next, lane); r < R; r = next_ray(next, lane))
    march_ray<kCov>(r, lane, tile, keys, ro, rd, near, far, step, u_jitter, absorb,
              prm, out, n, max_steps, spherical, refine, with_eval);
}

template <int kCov>
__global__ void __launch_bounds__(kLanes * kWarpsPerBlock)
ws_trace_kernel(int* __restrict__ next, int R,
                const int32_t* __restrict__ keys, const float* __restrict__ ro,
                const float* __restrict__ rd, const float* __restrict__ near,
                const float* __restrict__ far, const float* __restrict__ prm,
                float* __restrict__ out, int n, int max_iters, int spherical,
                int with_eval) {
  const int lane = threadIdx.x % kLanes;
  __shared__ float tiles[kWarpsPerBlock][3 * kTile * kLanes];
  float* tile = tiles[threadIdx.x / kLanes] + lane;
  for (int64_t r = next_ray(next, lane); r < R; r = next_ray(next, lane))
    trace_ray<kCov>(r, lane, tile, keys, ro, rd, near, far, prm, out, n, max_iters,
              spherical, with_eval);
}

// Makes `device` current for the launch, then the caller's device again;
// returns the first error of the launch as an int.
template <typename Launch>
int on_device(int device, Launch launch) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = launch();
  if (err == cudaSuccess) err = cudaGetLastError();
  const cudaError_t restore = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restore);
}

// Launches `kernel` with as many blocks as the card holds at
// once (no more than the rays need), after zeroing the ray counter `next`
// on `stream`.
template <typename Kernel, typename... Args>
cudaError_t launch_persistent(Kernel kernel, int R, int* next,
                              cudaStream_t stream, Args... args) {
  if (R <= 0) return cudaSuccess;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kLanes * kWarpsPerBlock, 0);
  if (err == cudaSuccess) err = cudaMemsetAsync(next, 0, sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const int need = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int blocks = per_sm * sms < need ? per_sm * sms : need;
  kernel<<<blocks > 0 ? blocks : 1, kLanes * kWarpsPerBlock, 0, stream>>>(
      next, R, args...);
  return cudaSuccess;
}

// K5's instance for covariance kCov over R rays (the arguments of ws_march)
template <int kCov>
int march_instance(const void* keys, const void* ro, const void* rd,
                   const void* near, const void* far, const void* step,
                   const void* u_jitter, const void* absorb,
                   const void* params, void* out, void* next, int R, int n,
                   int max_steps, int spherical, int refine, int with_eval,
                   int device, void* stream) {
  return on_device(device, [&] {
    const cudaStream_t s = (cudaStream_t)stream;
    return launch_persistent(
        ws_march_kernel<kCov>, R, (int*)next, s, (const int32_t*)keys,
        (const float*)ro, (const float*)rd, (const float*)near,
        (const float*)far, (const float*)step, (const float*)u_jitter,
        (const uint8_t*)absorb, (const float*)params, (float*)out, n,
        max_steps, spherical, refine, with_eval);
  });
}

// K4's instance for covariance kCov over R rays (the arguments of ws_trace)
template <int kCov>
int trace_instance(const void* keys, const void* ro, const void* rd,
                   const void* near, const void* far, const void* params,
                   void* out, void* next, int R, int n, int max_iters,
                   int spherical, int with_eval, int device, void* stream) {
  return on_device(device, [&] {
    const cudaStream_t s = (cudaStream_t)stream;
    return launch_persistent(
        ws_trace_kernel<kCov>, R, (int*)next, s, (const int32_t*)keys,
        (const float*)ro, (const float*)rd, (const float*)near,
        (const float*)far, (const float*)params, (float*)out, n, max_iters,
        spherical, with_eval);
  });
}

}  // namespace

// K5 over R rays: keys [R, 2] int32 (uint32 words), ro and rd [R, 3], near,
// far, step and u_jitter [R] float32, absorb [R] uint8, params [14] float32;
// writes out [R, 8] float32; next: one int of scratch (the ray counter);
// cov: the covariance tag, whose instance runs.
extern "C" int ws_march(const void* keys, const void* ro, const void* rd,
                        const void* near, const void* far, const void* step,
                        const void* u_jitter, const void* absorb,
                        const void* params, void* out, void* next, int R,
                        int n, int max_steps, int spherical, int refine,
                        int with_eval, int cov, int device, void* stream) {
#define WS_MARCH(tag)                                                        \
  march_instance<tag>(keys, ro, rd, near, far, step, u_jitter, absorb,      \
                      params, out, next, R, n, max_steps, spherical, refine, \
                      with_eval, device, stream)
  switch (cov) {
    case kSE: return WS_MARCH(kSE);
    case kRQ: return WS_MARCH(kRQ);
    case kMatern: return WS_MARCH(kMatern);
    case kGabor: return WS_MARCH(kGabor);
    case kPeriodic: return WS_MARCH(kPeriodic);
    case kThinPlate: return WS_MARCH(kThinPlate);
    default: return (int)cudaErrorInvalidValue;
  }
#undef WS_MARCH
}

// K4 over R rays: keys, ro, rd, near, far, params, out, next and cov as
// ws_march's.
extern "C" int ws_trace(const void* keys, const void* ro, const void* rd,
                        const void* near, const void* far, const void* params,
                        void* out, void* next, int R, int n, int max_iters,
                        int spherical, int with_eval, int cov, int device,
                        void* stream) {
#define WS_TRACE(tag)                                                     \
  trace_instance<tag>(keys, ro, rd, near, far, params, out, next, R, n,  \
                      max_iters, spherical, with_eval, device, stream)
  switch (cov) {
    case kSE: return WS_TRACE(kSE);
    case kRQ: return WS_TRACE(kRQ);
    case kMatern: return WS_TRACE(kMatern);
    case kGabor: return WS_TRACE(kGabor);
    case kPeriodic: return WS_TRACE(kPeriodic);
    case kThinPlate: return WS_TRACE(kThinPlate);
    default: return (int)cudaErrorInvalidValue;
  }
#undef WS_TRACE
}
