// K5 and K4: weight-space ray marching over per-ray random Fourier feature
// (RFF) realizations.
//
// K5 (ws_march_chunk) replaces tungsten_tpu/ops/ws_trace_pallas.py::
// _march_kernel (launched by _march_chunk): `chunk` fixed steps of
//   f(tc) = scale * sum_i amp_i cos(a_i + slope_i tc) + mean(tc),
//   tc = t1 + step * k,
// recording the first sign flip against sign0 as (t_hi, f_lo, f_hi); the
// first step after an interior scatter (absorb) sets sign0 and cannot flip.
// K4 (ws_trace_chunk) replaces the same file's _trace_kernel (launched by
// _trace_chunk): `chunk` adaptive range-bound iterations over [t, t+step],
// bounding each basis term by the exact cos interval of its phase range and
// the mean by its midpoint value +- Lipschitz * half-length; the step grows
// x1.6 while the bound excludes zero and halves otherwise, and a hit is
// declared when a sign-ambiguous step is at most min_step.
//
// State and aux columns are those of the Pallas kernels:
//   K5 state [k, done, crossed, t_hi, f_lo, f_hi, sign0, f_prev],
//      aux [A, B, far, t1, step, absorb, -, -], params [scale, radius,
//      mean_offset, ...];
//   K4 state [t, step, done, hit, sign0, it, -, -], aux [A, B, far, ...],
//      params [scale, min_step, lip_mean, radius, mean_offset, ...];
// A = |ro - c|^2 and B = (ro - c) . rd give the spherical mean
// sqrt(A + t (2B + t)) - radius; a homogeneous mean is mean_offset.
//
// What bounds them: the transcendentals.  At n = 1024 a ray reads 12 KB of
// basis (a, slope, amp) per dispatch and, per step, K5 does n precise cosf
// and 2n other flops (32 n cosf per dispatch); K4 does 2n cosf, 4n divides
// and floors and ~10n other flops per iteration (16 * 2n cosf per dispatch).
// The basis is re-read from global memory (L1/L2) at every step.
//
// Design: simple and exact first.  One warp per ray, 8 rays per 256-thread
// block, the tail of the ray batch masked (no padding).  Lane j takes basis
// functions j, j+32, ...; a __shfl_xor_sync butterfly sums the lanes (every
// lane ends with the same bits, so the warp takes one branch).  The ray's
// state lives in registers across the chunk, and a finished ray's warp
// stops early: afterwards the Pallas kernel changes nothing for it but K5's
// sign0, which it sets at most once (absorb on step 0).  Precise cosf, no
// fast math, built with -fmad=false, and K4 divides by float32(2 pi) with
// `/` (no reciprocal), so each basis term rounds as in the plain PyTorch
// twins (kernels/ws_trace.py); only the order of the n-term sums differs.
// Later work: keep the basis in shared memory or registers across steps,
// or synthesise it in-kernel from the ray's hash key.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr float kTwoPi = 6.2831855f;  // float32(2 pi)
constexpr float kPi = 3.1415927f;     // float32(pi)

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float mean_at(bool spherical, float A, float B,
                                         float t, float radius, float m_off) {
  if (!spherical) return m_off;
  const float d2 = A + t * (2.0f * B + t);
  return sqrtf(fmaxf(d2, 0.0f)) - radius;
}

__global__ void __launch_bounds__(256)
ws_march_kernel(const float* __restrict__ a, const float* __restrict__ slope,
                const float* __restrict__ amp, const float* __restrict__ aux,
                const float* __restrict__ state_in,
                float* __restrict__ state_out,
                const float* __restrict__ params, int R, int n, int chunk,
                int spherical) {
  const int lane = threadIdx.x & 31;
  const int64_t ray =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (ray >= R) return;  // the whole warp leaves together
  const float scale = params[0];
  const float radius = params[1];
  const float m_off = params[2];
  const float* ar = a + ray * n;
  const float* sr = slope + ray * n;
  const float* mr = amp + ray * n;
  const float* x = aux + ray * 8;
  const float A = x[0], B = x[1], far = x[2], t1 = x[3], step = x[4];
  const bool absorb = x[5] > 0.5f;
  const float* s = state_in + ray * 8;
  float k = s[0];
  bool done = s[1] > 0.5f;
  float crossed = s[2], t_hi = s[3], f_lo = s[4], f_hi = s[5];
  float sign0 = s[6], f_prev = s[7];

  for (int it = 0; it < chunk; ++it) {
    const bool was_done = done;
    const bool first = k < 0.5f;
    if (was_done && !(absorb && first)) break;
    const float tc = t1 + step * k;
    float acc = 0.0f;
    for (int j = lane; j < n; j += 32) acc += mr[j] * cosf(ar[j] + sr[j] * tc);
    const float nsum = warp_sum(acc);
    const float f = scale * nsum + mean_at(spherical, A, B, tc, radius, m_off);
    const float sgn = f < 0.0f ? -1.0f : 1.0f;
    sign0 = (absorb && first) ? sgn : sign0;
    if (was_done) break;  // a done ray changes only sign0, and only here
    const bool flip = (sgn != sign0) && (tc < far) && !(absorb && first);
    const bool exited = tc >= far;
    if (flip) {
      crossed = 1.0f;
      t_hi = tc;
      f_hi = f;
      f_lo = f_prev;
    }
    if (flip || exited) {
      done = true;
    } else {
      k += 1.0f;
      f_prev = f;
    }
  }
  if (lane == 0) {
    float* o = state_out + ray * 8;
    o[0] = k;
    o[1] = done ? 1.0f : 0.0f;
    o[2] = crossed;
    o[3] = t_hi;
    o[4] = f_lo;
    o[5] = f_hi;
    o[6] = sign0;
    o[7] = f_prev;
  }
}

__global__ void __launch_bounds__(256)
ws_trace_kernel(const float* __restrict__ a, const float* __restrict__ slope,
                const float* __restrict__ amp, const float* __restrict__ aux,
                const float* __restrict__ state_in,
                float* __restrict__ state_out,
                const float* __restrict__ params, int R, int n, int chunk,
                int spherical) {
  const int lane = threadIdx.x & 31;
  const int64_t ray =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (ray >= R) return;
  const float scale = params[0];
  const float min_step = params[1];
  const float lip_m = params[2];
  const float radius = params[3];
  const float m_off = params[4];
  const float* ar = a + ray * n;
  const float* sr = slope + ray * n;
  const float* mr = amp + ray * n;
  const float* x = aux + ray * 8;
  const float A = x[0], B = x[1], far = x[2];
  const float* s = state_in + ray * 8;
  float t = s[0], step = s[1];
  bool done = s[2] > 0.5f;
  float hit = s[3];
  const float sign0 = s[4];
  float iters = s[5];

  for (int it = 0; it < chunk && !done; ++it) {
    const float t_end = t + step;
    float acc_lo = 0.0f, acc_hi = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float th0 = ar[j] + sr[j] * t;
      const float th1 = ar[j] + sr[j] * t_end;
      const float lo = fminf(th0, th1);
      const float hi = fmaxf(th0, th1);
      const float c_lo = cosf(lo);
      const float c_hi = cosf(hi);
      float cmin = fminf(c_lo, c_hi);
      float cmax = fmaxf(c_lo, c_hi);
      const bool k_even = floorf(hi / kTwoPi) - floorf(lo / kTwoPi) >= 1.0f;
      const bool k_odd =
          floorf((hi - kPi) / kTwoPi) - floorf((lo - kPi) / kTwoPi) >= 1.0f;
      const bool wide = (hi - lo) >= kTwoPi;
      if (k_even || wide) cmax = 1.0f;
      if (k_odd || wide) cmin = -1.0f;
      const float w = mr[j];
      acc_lo += fminf(w * cmin, w * cmax);
      acc_hi += fmaxf(w * cmin, w * cmax);
    }
    const float n_lo = scale * warp_sum(acc_lo);
    const float n_hi = scale * warp_sum(acc_hi);
    const float tm = t + 0.5f * step;
    const float m_mid = mean_at(spherical, A, B, tm, radius, m_off);
    const float half = 0.5f * step * lip_m;
    const float lo_b = n_lo + m_mid - half;
    const float hi_b = n_hi + m_mid + half;
    const bool no_cross = sign0 > 0.0f ? lo_b > 0.0f : hi_b < 0.0f;
    const bool converged = !no_cross && step <= min_step;
    const float t_new = no_cross ? t + step : t;
    float step_new = no_cross ? step * 1.6f : step * 0.5f;
    step_new = fmaxf(step_new, min_step * 0.5f);
    const bool exited = t_new >= far;
    step_new = fminf(step_new, far - t_new + 1e-6f);
    t = t_new;
    step = step_new;
    if (converged) hit = 1.0f;
    done = converged || exited;
    iters += 1.0f;
  }
  if (lane == 0) {
    float* o = state_out + ray * 8;
    o[0] = t;
    o[1] = step;
    o[2] = done ? 1.0f : 0.0f;
    o[3] = hit;
    o[4] = sign0;
    o[5] = iters;
    o[6] = s[6];
    o[7] = s[7];
  }
}

typedef void (*KernelFn)(const float*, const float*, const float*,
                         const float*, const float*, float*, const float*, int,
                         int, int, int);

// Launches `kernel` on `stream` of `device`, then makes the caller's current
// device current again; returns the launch's cudaGetLastError() as an int.
int launch(KernelFn kernel, const void* a, const void* slope, const void* amp,
           const void* aux, const void* state_in, void* state_out,
           const void* params, int R, int n, int chunk, int spherical,
           int device, void* stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R > 0) {
    const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
    kernel<<<blocks, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)slope, (const float*)amp,
        (const float*)aux, (const float*)state_in, (float*)state_out,
        (const float*)params, R, n, chunk, spherical);
  }
  err = cudaGetLastError();
  const cudaError_t restore = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restore);
}

}  // namespace

extern "C" int ws_march_chunk(const void* a, const void* slope,
                              const void* amp, const void* aux,
                              const void* state_in, void* state_out,
                              const void* params, int R, int n, int chunk,
                              int spherical, int device, void* stream) {
  return launch(ws_march_kernel, a, slope, amp, aux, state_in, state_out,
                params, R, n, chunk, spherical, device, stream);
}

extern "C" int ws_trace_chunk(const void* a, const void* slope,
                              const void* amp, const void* aux,
                              const void* state_in, void* state_out,
                              const void* params, int R, int n, int chunk,
                              int spherical, int device, void* stream) {
  return launch(ws_trace_kernel, a, slope, amp, aux, state_in, state_out,
                params, R, n, chunk, spherical, device, stream);
}
