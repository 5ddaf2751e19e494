// K8: eigh of a batch of small symmetric float32 matrices [B, n, n], n <= 64,
// by cyclic parallel Jacobi, for the function-space medium's dense solves.
//
// Replaces tungsten_tpu/ops/gp.py's jnp.linalg.eigh (:127 in _sqrt_psd, :148
// in pseudo_inverse), which XLA lowers to a LAPACK or solver call; it is not
// a Pallas kernel.  On the function-space path every active ray needs, per
// chunk, the root of its [n + 1] = 33-square joint covariance and, per
// segment, the pseudo-inverse of its [n + 2] = 34-square conditioning block
// and the root of a 3x3; torch.linalg.eigh would batch only up to 32x32 in
// cuSOLVER's Jacobi and loop over larger matrices one solver call each.
//
// Algorithm: one thread block per matrix, the matrix A (float32) and the
// rotations' product V (float64) in shared memory (12 n (n | 1) bytes, 14 KB
// at n = 34; rows padded to an odd stride so that the column phase's strided
// accesses spread over the banks).  A sweep is m - 1 rounds of the circle
// method over m = n rounded up to even indices (a pair holding the padding
// index n is skipped), so each round rotates floor(n / 2) disjoint pairs (p,
// q) at once: warp 0 computes each pair's rotation (Golub and Van Loan's
// symmetric Schur: tau = (a_qq - a_pp) / 2 a_pq, t = sign(tau) / (|tau| +
// sqrt(1 + tau^2)), c = 1 / sqrt(1 + t^2), s = t c) and packs the valid pairs
// with a ballot; then all threads apply J^T to rows p, q of A, and J to
// columns p, q of A and V, one element of a pair per loop iteration; the
// rotated a_pq and a_qp are set to 0.  Each rotation is computed in float64
// from A's float32 entries and V is accumulated in float64: in float32, c^2 +
// s^2 and V's rounding drift by about an ulp per rotation, and V^T V strayed
// ~1e-5 from I over the ~300 rotations a column takes at n = 33 (a numpy
// emulation of this loop); in float64 it stays within ~4e-7 once rounded to
// float32.  A is rotated in float32.  A sweep starts with the squared
// off-diagonal norm; the matrix is done when it is at most (1e-7)^2 times the
// squared Frobenius norm, or after 15 sweeps.  The input is symmetrized on
// load (0.5 (a + a^T)), as the twin does.  The eigenvalues are the diagonal,
// sorted ascending with V's columns as torch.linalg.eigh returns them (a NaN
// sorts last); the sweeps taken are written per matrix.
//
// What bounds it: shared memory, then operations.  A sweep applies n(n - 1)/2
// rotations of 6n float operations each to A's rows, 6n to its columns and
// 6n double ones to V, about 340,000 at n = 34, and moves 64 bytes of shared
// memory per pair-element, against 9 KB read and written once.  Both element
// loops are kept rolled (#pragma unroll 1), so that kernels/sass.py
// jacobi_counts reads the instructions of one iteration per element off the
// SASS, to set beside the ~30 a rotation needs.  Tensor cores have no work
// here: a rotation is not a matrix product.  Built with -fmad=false, like the
// other kernels.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_N = 64;
constexpr int MAX_SWEEPS = 15;
constexpr float TOL = 1e-7f;

// index of player i in round r of the circle method over m (even) players
__device__ __forceinline__ int circle(int i, int r, int m) {
  return i == 0 ? 0 : (i - 1 + r) % (m - 1) + 1;
}

// sum of v over the block, returned to every thread
template <int THREADS>
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // red is free again
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int k = 0; k < THREADS / 32; ++k) s += red[k];
  return s;
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS)
    jacobi_eigh_kernel(const float* __restrict__ a_in, float* __restrict__ w,
                       float* __restrict__ v, int* __restrict__ sweeps_out,
                       int n) {
  extern __shared__ double smem[];
  __shared__ int pp[MAX_N / 2], qq[MAX_N / 2], rank[MAX_N];
  __shared__ float cc[MAX_N / 2], ss[MAX_N / 2], red[THREADS / 32];
  __shared__ double cd[MAX_N / 2], sd[MAX_N / 2];
  __shared__ int npairs;
  const int ld = n | 1;
  double* V = smem;
  float* A = (float*)(smem + n * ld);
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const float* src = a_in + b * n * n;

  float part = 0.f;
  for (int e = tid; e < n * n; e += THREADS) {
    const int i = e / n, j = e - i * n;
    const float x = 0.5f * (src[i * n + j] + src[j * n + i]);
    A[i * ld + j] = x;
    V[i * ld + j] = i == j ? 1.0 : 0.0;
    part += x * x;
  }
  if (tid == 0) npairs = 0;
  const float fro2 = block_sum<THREADS>(part, red);

  const int m = n + (n & 1);
  // each thread's first (pair, element) and its stride over pair-elements
  const int k0 = tid / n, j0 = tid - k0 * n;
  const int dk = THREADS / n, dj = THREADS - dk * n;
  int sweeps = 0;
  for (; sweeps < MAX_SWEEPS; ++sweeps) {
    part = 0.f;
    for (int e = tid; e < n * n; e += THREADS) {
      const int i = e / n, j = e - i * n;
      const float x = A[i * ld + j];
      part += i == j ? 0.f : x * x;
    }
    const float off2 = block_sum<THREADS>(part, red);
    if (!(off2 > TOL * TOL * fro2)) break;
    for (int r = 0; r < m - 1; ++r) {
      if (tid < 32) {
        // the last round's rotated entries are zero
        if (tid < npairs) {
          A[pp[tid] * ld + qq[tid]] = 0.f;
          A[qq[tid] * ld + pp[tid]] = 0.f;
        }
        __syncwarp();
        int p = 0, q = 0;
        bool valid = false;
        if (tid < m / 2) {
          p = circle(tid, r, m);
          q = circle(m - 1 - tid, r, m);
          if (p > q) {
            const int x = p;
            p = q;
            q = x;
          }
          valid = q < n;
        }
        const unsigned mask = __ballot_sync(0xffffffffu, valid);
        __syncwarp();
        if (valid) {
          const int pos = __popc(mask & ((1u << tid) - 1u));
          const double app = A[p * ld + p], aqq = A[q * ld + q];
          const double apq = A[p * ld + q];
          double c = 1.0, s = 0.0;
          if (apq != 0.0) {
            const double tau = (aqq - app) / (2.0 * apq);
            const double t = (tau >= 0.0 ? 1.0 : -1.0) /
                             (fabs(tau) + sqrt(1.0 + tau * tau));
            c = 1.0 / sqrt(1.0 + t * t);
            s = t * c;
          }
          pp[pos] = p;
          qq[pos] = q;
          cd[pos] = c;
          sd[pos] = s;
          cc[pos] = (float)c;
          ss[pos] = (float)s;
        }
        if (tid == 0) npairs = __popc(mask);
      }
      __syncthreads();
      const int np = npairs;
      // rows p and q of A <- J^T A
      int k = k0, j = j0;
#pragma unroll 1
      while (k < np) {
        const int p = pp[k], q = qq[k];
        const float c = cc[k], s = ss[k];
        const float x = A[p * ld + j], y = A[q * ld + j];
        A[p * ld + j] = c * x - s * y;
        A[q * ld + j] = s * x + c * y;
        j += dj;
        k += dk;
        if (j >= n) {
          j -= n;
          ++k;
        }
      }
      __syncthreads();
      // columns p and q of A <- A J, and of V <- V J
      k = k0;
      int i = j0;
#pragma unroll 1
      while (k < np) {
        const int p = pp[k], q = qq[k];
        const float c = cc[k], s = ss[k];
        const float x = A[i * ld + p], y = A[i * ld + q];
        A[i * ld + p] = c * x - s * y;
        A[i * ld + q] = s * x + c * y;
        const double c2 = cd[k], s2 = sd[k];
        const double vx = V[i * ld + p], vy = V[i * ld + q];
        V[i * ld + p] = c2 * vx - s2 * vy;
        V[i * ld + q] = s2 * vx + c2 * vy;
        i += dj;
        k += dk;
        if (i >= n) {
          i -= n;
          ++k;
        }
      }
      __syncthreads();
    }
    // (the next sweep's first round zeroes these entries again: a no-op)
    if (tid < npairs) {
      A[pp[tid] * ld + qq[tid]] = 0.f;
      A[qq[tid] * ld + pp[tid]] = 0.f;
    }
    __syncthreads();
  }

  // ascending order (NaN last, ties by index), as torch.linalg.eigh
  if (tid < n) {
    const float wi = A[tid * ld + tid];
    const float ki = isnan(wi) ? INFINITY : wi;
    int r = 0;
    for (int jj = 0; jj < n; ++jj) {
      const float wj = A[jj * ld + jj];
      const float kj = isnan(wj) ? INFINITY : wj;
      r += (kj < ki) || (kj == ki && jj < tid);
    }
    rank[tid] = r;
    w[b * n + r] = wi;
  }
  if (tid == 0) sweeps_out[b] = sweeps;
  __syncthreads();
  float* vo = v + b * n * n;
  for (int e = tid; e < n * n; e += THREADS) {
    const int row = e / n, col = e - row * n;
    vo[row * n + rank[col]] = (float)V[row * ld + col];
  }
}

}  // namespace

// K8 on `batch` matrices [batch, n, n] (float32, contiguous): eigenvalues
// w [batch, n] ascending, eigenvectors v [batch, n, n] (columns), and the
// sweeps each matrix took [batch] (int32).
extern "C" int psd_eigh(const void* a, void* w, void* v, void* sweeps,
                        int batch, int n, int device, void* stream) {
  if (n < 1 || n > MAX_N) return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0) {
    const int smem =
        (int)((size_t)n * (size_t)(n | 1) * (sizeof(double) + sizeof(float)));
    const cudaStream_t s = (cudaStream_t)stream;
    if (n <= 8) {
      jacobi_eigh_kernel<32><<<batch, 32, smem, s>>>(
          (const float*)a, (float*)w, (float*)v, (int*)sweeps, n);
    } else {
      // above 48 KB (n > 59) only after opting in
      err = cudaFuncSetAttribute(jacobi_eigh_kernel<128>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err == cudaSuccess) {
        jacobi_eigh_kernel<128><<<batch, 128, smem, s>>>(
            (const float*)a, (float*)w, (float*)v, (int*)sweeps, n);
      }
    }
  }
  err = cudaGetLastError();
  const cudaError_t restore = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restore);
}
