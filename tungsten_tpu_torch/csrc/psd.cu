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
// Algorithm: one thread block per matrix, the matrix A (float32, its upper
// triangle) and the rotations' product V (float64) in shared memory.  A
// sweep is m - 1 rounds of the circle method over m = n rounded up to even
// indices, so each round rotates m / 2 disjoint pairs at once; for odd n, A
// has a zero padding row and column n, and the pair holding n has a_pq = 0,
// hence the identity rotation.  A round is two steps, each ended by a
// barrier:
//
// 1. One thread a pair (x, y), p = min, q = max, computes its rotation
//    (Golub and Van Loan's symmetric Schur: tau = (a_qq - a_pp) / 2 a_pq,
//    t = sign(tau) / (|tau| + sqrt(1 + tau^2)), c = 1 / sqrt(1 + t^2),
//    s = t c) and updates the pair's diagonal block: a_pp - t a_pq,
//    a_qq + t a_pq, a_pq = 0.
// 2. One fused pass: every off-diagonal 2x2 block of A is rotated once,
//    A[I_i, I_j] <- J_i^T A[I_i, I_j] J_j for pairs I_i, I_j (i < j): a
//    thread reads the block's four entries, applies the row and then the
//    column rotation, and writes them back.  A is symmetric, so each entry
//    is kept once and is read and written once a round.  The same pass
//    rotates V's columns, V[i, I_j] <- V[i, I_j] J_j: a warp takes a pair
//    and 32 rows, the rows left over (n mod 32) a thread a unit.
//
// A is stored by the circle's slots, not by index: pair i of a round holds
// the players in slots i and m - 1 - i, kept at positions 2i and 2i + 1,
// so block (i, j) of every round sits at the same place.  A block's four
// entries lie in four planes at one offset (off-diagonal blocks by their
// distance j - i from the diagonal, then the diagonal ones), so a warp
// reads consecutive words and, as most entries move one block along their
// diagonal, mostly writes consecutive words too.  From
// one round to the next every player moves one slot down the circle (slot
// 1 to m - 1, slot 0 stays), the same permutation each round: the pass
// reads a round's buffer and writes each rotated entry to its place in the
// next round's, the other of two buffers, by a table made once per launch.
// After m - 1 rounds the slots are back where a sweep began.
//
// A pair keeps the circle's order (x, y), with s negated where x > y, which
// rounds exactly as rotating (p, q) by (c, s).  n is a template parameter
// for the path's sizes (3, 33, 34), so the loops unroll, and the occupancy
// is set to 12 blocks an SM; one generic instance takes any other 1 <= n
// <= 64.  V's rows are padded to an odd stride, so a warp's 32 rows of a
// column fall in distinct banks.
//
// Each rotation is computed in float64 from A's float32 entries and V is
// accumulated in float64: in float32, c^2 + s^2 and V's rounding drift by
// about an ulp per rotation, and V^T V strayed ~1e-5 from I over the ~300
// rotations a column takes at n = 33; in float64 it stays within ~4e-7 once
// rounded to float32.  A is rotated in float32.  A sweep starts with the
// squared off-diagonal norm; the matrix is done when it is at most (1e-7)^2
// times the squared Frobenius norm, or after 15 sweeps.  The input is
// symmetrized on load (0.5 (a + a^T)), as the twin does.  The eigenvalues are
// the diagonal, sorted ascending with V's columns as torch.linalg.eigh
// returns them (a NaN sorts last); the sweeps taken are written per matrix.
//
// What bounds it: shared memory and issue together.  A round moves A's
// entries once (8 bytes each, read and written) and V's (row, pair) units
// (32 bytes each): 23,256 bytes at n = 34, 40 per pair-element (a pair and
// one of the n indices), against 9 KB read from and written to device
// memory once per matrix.  V's indices are loaded, not computed from
// circle(): the computation issues more than the load saves.  Tensor
// cores have no work here: a rotation is not a matrix product.  Built
// with -fmad=false, like the other kernels.

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

// A's position of slot s (0 <= s < m), and the slot at position a
__device__ __forceinline__ int pos_of(int s, int m) {
  return s < m / 2 ? 2 * s : 2 * (m - 1 - s) + 1;
}
__device__ __forceinline__ int slot_at(int a, int m) {
  return a & 1 ? m - 1 - (a >> 1) : a >> 1;
}
// where the entry at position a moves for the next round
__device__ __forceinline__ int next_pos(int a, int m) {
  const int s = slot_at(a, m);
  return pos_of(s == 0 ? 0 : s == 1 ? m - 1 : s - 1, m);
}
// offset of A's entry (a, b) in a buffer of 4 planes of pl words: plane
// 2 (a & 1) + (b & 1) of a <= b, at block (a / 2, b / 2)'s offset: block
// (i, j), i < j, after the np - 1, np - 2, ... blocks of the diagonals
// closer than d = j - i, and the diagonal blocks (i, i) after all of them
__device__ __forceinline__ int entry_at(int a, int b, int np, int nb,
                                        int pl) {
  if (a > b) {
    const int t = a;
    a = b;
    b = t;
  }
  const int i = a >> 1, j = b >> 1;
  const int d = j - i;
  const int k = i < j ? (d - 1) * np - d * (d - 1) / 2 + i : nb + i;
  return ((a & 1) << 1 | (b & 1)) * pl + k;
}

// NT: n at compile time, or 0 to take it from the argument n
template <int NT, int THREADS>
__global__ void __launch_bounds__(THREADS, NT > 0 ? 12 : 1)
    jacobi_eigh_kernel(const float* __restrict__ a_in, float* __restrict__ w,
                       float* __restrict__ v, int* __restrict__ sweeps_out,
                       int n_arg) {
  constexpr int WARPS = THREADS / 32;
  constexpr int SN = NT > 0 ? NT : MAX_N, SP = (SN + 1) / 2;
  constexpr int SB = SP > 1 ? SP * (SP - 1) / 2 : 1;
  extern __shared__ double smem[];
  // each pair slot's rotation (c, s), in float32 and in float64, and its
  // indices (x, y)
  __shared__ float2 cs[SP];
  __shared__ double2 rot[SP];
  __shared__ int2 xy[SP];
  // off-diagonal block k: (i, j) and where its four entries go next round
  __shared__ unsigned short blk[SB];
  __shared__ ushort4 dst[SB];
  __shared__ int rank[SN];
  __shared__ float red[WARPS];
  const int n = NT > 0 ? NT : n_arg;
  const int m = n + (n & 1);
  const int np = m / 2;
  const int nb = np * (np - 1) / 2;  // off-diagonal blocks (i < j)
  const int pl = nb + np;            // a plane: every block's entry
  const int ldv = m | 1;
  double* V = smem;                         // n x ldv
  float* cur = (float*)(smem + n * ldv);    // A: 4 planes of pl, this round
  float* nxt = cur + 4 * pl;                // and the next
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x;
  const float* src = a_in + b * n * n;

  // block k of a round is (i, j), i < j, by diagonal d = j - i, then i
  for (int k = tid; k < nb; k += THREADS) {
    int d = 1, i = k;
    while (i >= np - d) i -= np - d++;
    const int j = i + d;
    blk[k] = (unsigned short)(i << 8 | j);
    const int x0 = next_pos(2 * i, m), x1 = next_pos(2 * i + 1, m);
    const int y0 = next_pos(2 * j, m), y1 = next_pos(2 * j + 1, m);
    dst[k] = make_ushort4(entry_at(x0, y0, np, nb, pl),
                          entry_at(x0, y1, np, nb, pl),
                          entry_at(x1, y0, np, nb, pl),
                          entry_at(x1, y1, np, nb, pl));
  }
  for (int e = tid; e < n * m; e += THREADS) {
    const int i = e / m, j = e - i * m;
    V[i * ldv + j] = i == j ? 1.0 : 0.0;
  }
  __syncthreads();
  // round 0 holds index x in slot x; plane 2 of a diagonal block is unused
  float part = 0.f;
  for (int e = tid; e < 4 * pl; e += THREADS) {
    const int c = e / pl, k = e - c * pl;
    const int i = k < nb ? blk[k] >> 8 : k - nb;
    const int j = k < nb ? blk[k] & 255 : k - nb;
    const int x = slot_at(2 * i + (c >> 1), m), y = slot_at(2 * j + (c & 1), m);
    float val = 0.f;
    if (x < n && y < n && (k < nb || c != 2))
      val = 0.5f * (src[x * n + y] + src[y * n + x]);
    cur[e] = val;
    part += (x == y ? 1.f : 2.f) * val * val;
  }
  const float fro2 = block_sum<THREADS>(part, red);

  // V's units: a warp a pair j and 32 rows, then the rows left over (n mod
  // 32 of each pair) a thread a unit
  const int v_chunks = n / 32, v_rows = 32 * v_chunks, v_rest = n - v_rows;
  const int v_tasks = np * v_chunks, r_units = np * v_rest;
  int sweeps = 0;
  for (; sweeps < MAX_SWEEPS; ++sweeps) {
    part = 0.f;
    for (int e = tid; e < 4 * pl; e += THREADS) {
      const int c = e / pl, k = e - c * pl;
      if (k < nb || c == 1) part += 2.f * cur[e] * cur[e];
    }
    const float off2 = block_sum<THREADS>(part, red);
    if (!(off2 > TOL * TOL * fro2)) break;
    for (int r = 0; r < m - 1; ++r) {
      if (tid < np) {
        const int x = circle(tid, r, m), y = circle(m - 1 - tid, r, m);
        const float axx = cur[nb + tid], ayy = cur[3 * pl + nb + tid];
        const double app = x < y ? axx : ayy, aqq = x < y ? ayy : axx;
        const double apq = cur[pl + nb + tid];
        double c = 1.0, s = 0.0, t = 0.0;
        if (apq != 0.0) {
          const double tau = (aqq - app) / (2.0 * apq);
          t = (tau >= 0.0 ? 1.0 : -1.0) / (fabs(tau) + sqrt(1.0 + tau * tau));
          c = 1.0 / sqrt(1.0 + t * t);
          s = t * c;
        }
        const float pp = (float)(app - t * apq), qq = (float)(aqq + t * apq);
        const int ax = next_pos(2 * tid, m), ay = next_pos(2 * tid + 1, m);
        nxt[entry_at(ax, ax, np, nb, pl)] = x < y ? pp : qq;
        nxt[entry_at(ay, ay, np, nb, pl)] = x < y ? qq : pp;
        nxt[entry_at(ax, ay, np, nb, pl)] = 0.f;
        // rotating (x, y) by (c, s') with s' = s for x = p and -s for x = q
        // rounds as rotating (p, q) by (c, s)
        if (x > y) s = -s;
        cs[tid] = make_float2((float)c, (float)s);
        rot[tid] = make_double2(c, s);
        xy[tid] = make_int2(x, y);
      }
      __syncthreads();
      // A's off-diagonal blocks A[I_i, I_j] <- J_i^T A[I_i, I_j] J_j, i < j,
      // into the next round's places
#pragma unroll
      for (int k0 = 0; k0 < (nb + THREADS - 1) / THREADS; ++k0) {
        const int k = tid + k0 * THREADS;
        if (k < nb) {
          const int ij = blk[k];
          const float2 ci = cs[ij >> 8], cj = cs[ij & 255];
          const float a00 = cur[k], a01 = cur[pl + k];
          const float a10 = cur[2 * pl + k], a11 = cur[3 * pl + k];
          const ushort4 to = dst[k];
          // rows x_i, y_i <- J_i^T
          const float u0 = ci.x * a00 - ci.y * a10, u1 = ci.x * a01 - ci.y * a11;
          const float w0 = ci.y * a00 + ci.x * a10, w1 = ci.y * a01 + ci.x * a11;
          // columns x_j, y_j <- J_j
          nxt[to.x] = cj.x * u0 - cj.y * u1;
          nxt[to.y] = cj.y * u0 + cj.x * u1;
          nxt[to.z] = cj.x * w0 - cj.y * w1;
          nxt[to.w] = cj.y * w0 + cj.x * w1;
        }
      }
      // V[:, I_j] <- V[:, I_j] J_j, row i
      auto rotate_v = [&](int i, int j) {
        const double2 cs2 = rot[j];
        const int2 col = xy[j];
        double* row = V + i * ldv;
        const double x = row[col.x], y = row[col.y];
        row[col.x] = cs2.x * x - cs2.y * y;
        row[col.y] = cs2.y * x + cs2.x * y;
      };
#pragma unroll
      for (int k0 = 0; k0 < (v_tasks + WARPS - 1) / WARPS; ++k0) {
        const int task = warp + k0 * WARPS;
        if (task < v_tasks) {
          const int j = task / max(v_chunks, 1);
          rotate_v(32 * (task - j * v_chunks) + lane, j);
        }
      }
#pragma unroll
      for (int k0 = 0; k0 < (r_units + THREADS - 1) / THREADS; ++k0) {
        const int u = tid + k0 * THREADS;
        if (u < r_units) {
          const int j = u / max(v_rest, 1);
          rotate_v(v_rows + u - j * v_rest, j);
        }
      }
      __syncthreads();
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
  }

  // ascending order (NaN last, ties by index), as torch.linalg.eigh; a
  // sweep ends with index x back in slot x
  auto diag = [&](int x) {
    const int a = pos_of(x, m);
    return cur[(a & 1 ? 3 * pl : 0) + nb + (a >> 1)];
  };
  if (tid < n) {
    const float wi = diag(tid);
    const float ki = isnan(wi) ? INFINITY : wi;
    int r = 0;
    for (int jj = 0; jj < n; ++jj) {
      const float wj = diag(jj);
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
    vo[row * n + rank[col]] = (float)V[row * ldv + col];
  }
}

// one launch of the instance <NT, THREADS> with `smem` bytes of dynamic
// shared memory (above 48 KB only after opting in)
template <int NT, int THREADS>
cudaError_t launch(const float* a, float* w, float* v, int* sweeps,
                   int batch, int n, int smem, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      jacobi_eigh_kernel<NT, THREADS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  jacobi_eigh_kernel<NT, THREADS><<<batch, THREADS, smem, s>>>(a, w, v,
                                                               sweeps, n);
  return cudaGetLastError();
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
    const size_t m = n + (n & 1), ldv = m | 1, np = m / 2;
    const size_t pl = np * (np - 1) / 2 + np;  // A's blocks, 2 x 4 planes
    const int smem = (int)(n * ldv * sizeof(double) + 8 * pl * sizeof(float));
    const cudaStream_t s = (cudaStream_t)stream;
    const float* af = (const float*)a;
    float *wf = (float*)w, *vf = (float*)v;
    int* sw = (int*)sweeps;
    switch (n) {
      case 3:
        err = launch<3, 32>(af, wf, vf, sw, batch, n, smem, s);
        break;
      case 33:
        err = launch<33, 128>(af, wf, vf, sw, batch, n, smem, s);
        break;
      case 34:
        err = launch<34, 128>(af, wf, vf, sw, batch, n, smem, s);
        break;
      default:
        err = n <= 8 ? launch<0, 32>(af, wf, vf, sw, batch, n, smem, s)
                     : launch<0, 128>(af, wf, vf, sw, batch, n, smem, s);
    }
  }
  const cudaError_t restore = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restore);
}
