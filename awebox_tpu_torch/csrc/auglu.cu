// Hand-written Hopper kernels of the augmented-KKT interior-point direction.
//
// They replace the XLA operations that awebox_tpu/parallel/batch.py runs in
// _auglu_solve (factor='lu') and _advance_state:
//
//   K1 kkt_assemble_scaled   batch.py:333-336, 409-413  assemble K(delta) and
//                            its Jacobi scaling kd, write Ks = kd K kd
//   K2 lu_factor_batched     batch.py:414  partial-pivot LU of Ks (f32)
//   K3 lu_solve_batched      batch.py:416-418  kd * lu_solve(lu, piv, kd * v)
//   K4 advance_state         batch.py:449-512  fraction-to-boundary step,
//                            dual safeguards and barrier update (f64)
//
// Layout follows the JAX package: lanes first, row-major. Every entry point
// is a plain C function that launches on the caller's stream and returns
// cudaGetLastError(). Build (no PyTorch headers):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libauglu.so auglu.cu
//
// Rounding: products and sums that must match the plain PyTorch version
// bit for bit use the __fmul_rn/__fadd_rn (__dmul_rn/__dadd_rn) intrinsics,
// which nvcc never contracts into FMAs. Clamps are written as comparisons
// that let a NaN through, as torch.clamp and jnp.clip do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// K1: assembly + Jacobi scaling.
// Bound by bytes: N*N*4 bytes written per lane (1.18 MB at N = 543) against
// (n*n + 2*m*n)*4 bytes read. Grid (row tiles, lanes); each block first
// recomputes the lane's N scale factors into shared memory (N divides and
// square roots, negligible next to its tile), then streams whole rows so
// that stores are coalesced. kd is written by the first tile of each lane.
// ---------------------------------------------------------------------------
constexpr int K1_ROWS = 8;
constexpr int K1_THREADS = 256;

__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return (x < lo) ? lo : x;  // NaN passes through
}

__device__ __forceinline__ float clamp_hi(float x, float hi) {
  return (x > hi) ? hi : x;  // NaN passes through
}

__global__ void kkt_assemble_scaled_kernel(
    const float* __restrict__ W, const float* __restrict__ A,
    const float* __restrict__ Dr, const float* __restrict__ freev,
    const double* __restrict__ delta, float* __restrict__ Ks,
    float* __restrict__ kd_out, int n, int m) {
  extern __shared__ float kd[];
  const int N = n + m;
  const int lane = blockIdx.y;
  const float* Wl = W + (size_t)lane * n * n;
  const float* Al = A + (size_t)lane * m * n;
  const float* Drl = Dr + (size_t)lane * m;
  float* Kl = Ks + (size_t)lane * N * N;
  const float d32 = __double2float_rn(delta[lane]);

  for (int t = threadIdx.x; t < N; t += blockDim.x) {
    float diag;
    if (t < n) {
      diag = fabsf(__fadd_rn(Wl[(size_t)t * n + t], __fmul_rn(d32, freev[t])));
    } else {
      diag = Drl[t - n];
    }
    float r = 1.0f / sqrtf(clamp_lo(diag, 1e-8f));
    r = clamp_hi(clamp_lo(r, 0.0f), 1e4f);
    kd[t] = r;
    if (blockIdx.x == 0) kd_out[(size_t)lane * N + t] = r;
  }
  __syncthreads();

  const int row0 = blockIdx.x * K1_ROWS;
  for (int r = 0; r < K1_ROWS; ++r) {
    const int i = row0 + r;
    if (i >= N) break;
    const float kdi = kd[i];
    float* Krow = Kl + (size_t)i * N;
    for (int j = threadIdx.x; j < N; j += blockDim.x) {
      float k;
      if (i < n) {
        if (j < n) {
          k = Wl[(size_t)i * n + j];
          if (i == j) k = __fadd_rn(k, __fmul_rn(d32, freev[i]));
        } else {
          k = Al[(size_t)(j - n) * n + i];  // A^T block
        }
      } else {
        if (j < n) {
          k = Al[(size_t)(i - n) * n + j];
        } else {
          k = (i == j) ? -Drl[i - n] : -0.0f;
        }
      }
      Krow[j] = __fmul_rn(__fmul_rn(k, kdi), kd[j]);
    }
  }
}

// ---------------------------------------------------------------------------
// K2: right-looking unblocked partial-pivot LU, one thread block per lane.
// The 1.18 MB lane matrix is far above the 227 KB of shared memory, so it
// stays in global memory and is served from L2 (50 MB holds every lane at
// the slice's batch). Per column: block-wide argmax of |a_ik| (warp
// shuffles, then one shared slot per warp; ties keep the lower row as
// LAPACK's isamax does), row swap, column scale by division, and a rank-1
// update of the trailing block in which consecutive threads own
// consecutive columns (coalesced) and the multiplier a_ik is a broadcast
// load. Bound by the trailing-update traffic through L2: about
// 2 N^3 / 3 * 8 bytes per lane. A zero pivot is not clamped: the division
// makes inf/NaN that reach the solution, so the caller's finiteness test
// fails and the regularization ladder retries, as with LAPACK in the JAX
// package.
// ---------------------------------------------------------------------------
constexpr int K2_THREADS = 1024;
constexpr int K2_COLS = 128;                 // columns per pass
constexpr int K2_ROWSTEP = K2_THREADS / K2_COLS;

__global__ void __launch_bounds__(K2_THREADS)
lu_factor_kernel(float* __restrict__ Ks, int32_t* __restrict__ piv, int N) {
  __shared__ float s_val[K2_THREADS / 32];
  __shared__ int s_idx[K2_THREADS / 32];
  __shared__ int s_p;
  const int lane = blockIdx.x;
  float* a = Ks + (size_t)lane * N * N;
  int32_t* pv = piv + (size_t)lane * N;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, wl = tid & 31;

  for (int k = 0; k < N; ++k) {
    // --- pivot search over rows k..N-1 of column k
    float best = -1.0f;
    int bidx = N;
    for (int i = k + tid; i < N; i += K2_THREADS) {
      float v = fabsf(a[(size_t)i * N + k]);
      if (v > best) { best = v; bidx = i; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      float ov = __shfl_down_sync(0xffffffffu, best, off);
      int oi = __shfl_down_sync(0xffffffffu, bidx, off);
      if (ov > best || (ov == best && oi < bidx)) { best = ov; bidx = oi; }
    }
    if (wl == 0) { s_val[warp] = best; s_idx[warp] = bidx; }
    __syncthreads();
    if (tid == 0) {
      float bv = s_val[0];
      int bi = s_idx[0];
      for (int w = 1; w < K2_THREADS / 32; ++w) {
        if (s_val[w] > bv || (s_val[w] == bv && s_idx[w] < bi)) {
          bv = s_val[w]; bi = s_idx[w];
        }
      }
      if (bi >= N) bi = k;   // column of NaNs: keep the diagonal
      s_p = bi;
      pv[k] = bi + 1;        // LAPACK's 1-based convention
    }
    __syncthreads();
    const int p = s_p;

    // --- swap rows k and p over all columns
    if (p != k) {
      for (int j = tid; j < N; j += K2_THREADS) {
        float t = a[(size_t)k * N + j];
        a[(size_t)k * N + j] = a[(size_t)p * N + j];
        a[(size_t)p * N + j] = t;
      }
    }
    __syncthreads();

    // --- scale the column below the pivot
    const float pivot = a[(size_t)k * N + k];
    for (int i = k + 1 + tid; i < N; i += K2_THREADS) {
      a[(size_t)i * N + k] = a[(size_t)i * N + k] / pivot;
    }
    __syncthreads();

    // --- rank-1 update of the trailing block
    const int ncol = N - k - 1;
    const int jo = tid % K2_COLS;
    const int io = tid / K2_COLS;
    for (int jb = 0; jb < ncol; jb += K2_COLS) {
      const int j = k + 1 + jb + jo;
      if (j < N) {
        const float u = a[(size_t)k * N + j];
        for (int i = k + 1 + io; i < N; i += K2_ROWSTEP) {
          a[(size_t)i * N + j] -= a[(size_t)i * N + k] * u;
        }
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K3: x = kd * lu_solve(lu, piv, kd * v), one thread block per lane. The
// right-hand side lives in shared memory; pivots are applied in order by
// one thread (N swaps), then each row of the unit-lower forward and the
// upper back substitution is one block-wide dot product over a contiguous
// (coalesced) row of the factor. Bound by latency: 2N dependent block
// reductions per solve, each reading at most N floats.
// ---------------------------------------------------------------------------
constexpr int K3_THREADS = 256;

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (wl == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
  if (tid == 0) {
    for (int w = 0; w < K3_THREADS / 32; ++w) s += red[w];
  }
  return s;  // valid in thread 0 only
}

__global__ void __launch_bounds__(K3_THREADS)
lu_solve_kernel(const float* __restrict__ lu, const int32_t* __restrict__ piv,
                const float* __restrict__ kd, const float* __restrict__ v,
                float* __restrict__ x, int N) {
  extern __shared__ float y[];
  __shared__ float red[K3_THREADS / 32];
  const int lane = blockIdx.x;
  const float* a = lu + (size_t)lane * N * N;
  const int32_t* pv = piv + (size_t)lane * N;
  const float* kdl = kd + (size_t)lane * N;
  const int tid = threadIdx.x;

  for (int i = tid; i < N; i += K3_THREADS) {
    y[i] = __fmul_rn(kdl[i], v[(size_t)lane * N + i]);
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 0; k < N; ++k) {
      const int p = pv[k] - 1;
      if (p != k) { float t = y[k]; y[k] = y[p]; y[p] = t; }
    }
  }
  __syncthreads();

  // forward substitution, unit lower triangle
  for (int i = 1; i < N; ++i) {
    float part = 0.0f;
    for (int j = tid; j < i; j += K3_THREADS) part += a[(size_t)i * N + j] * y[j];
    const float s = block_sum(part, red);
    if (tid == 0) y[i] -= s;
    __syncthreads();
  }
  // back substitution, upper triangle
  for (int i = N - 1; i >= 0; --i) {
    float part = 0.0f;
    for (int j = i + 1 + tid; j < N; j += K3_THREADS) part += a[(size_t)i * N + j] * y[j];
    const float s = block_sum(part, red);
    if (tid == 0) y[i] = (y[i] - s) / a[(size_t)i * N + i];
    __syncthreads();
  }

  for (int i = tid; i < N; i += K3_THREADS) {
    x[(size_t)lane * N + i] = __fmul_rn(kdl[i], y[i]);
  }
}

// ---------------------------------------------------------------------------
// K4: fraction-to-boundary step + dual safeguards + barrier update, f64,
// one thread block per lane. Two passes over the lane's O(n) vectors: the
// min-ratio reductions (block-wide, NaN-propagating like jnp.min), then the
// elementwise updates. Bound by latency and launch: a few KB per lane.
// ---------------------------------------------------------------------------
constexpr int K4_THREADS = 256;

// minimum/maximum that return NaN when either operand is NaN, like
// torch.minimum and jnp.minimum (fmin/fmax would drop the NaN)
__device__ __forceinline__ double nmin(double a, double b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

__device__ __forceinline__ double nmax(double a, double b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

// -tau * val / dval where dval < 0, else +inf (the ftb ratio)
__device__ __forceinline__ double ftb_ratio(double val, double dval, double tau) {
  return (dval < 0.0) ? __ddiv_rn(__dmul_rn(-tau, val), dval) : INFINITY;
}

__device__ __forceinline__ double block_min(double v, double* red) {
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  for (int off = 16; off > 0; off >>= 1) v = nmin(v, __shfl_down_sync(0xffffffffu, v, off));
  if (wl == 0) red[warp] = v;
  __syncthreads();
  if (tid == 0) {
    double s = red[0];
    for (int w = 1; w < K4_THREADS / 32; ++w) s = nmin(s, red[w]);
    red[0] = s;
  }
  __syncthreads();
  const double out = red[0];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(K4_THREADS)
advance_state_kernel(
    const double* __restrict__ w, const double* __restrict__ s,
    const double* __restrict__ y, const double* __restrict__ lam,
    const double* __restrict__ zl, const double* __restrict__ zu,
    const double* __restrict__ mu, const double* __restrict__ dw,
    const double* __restrict__ dy, const double* __restrict__ dlam,
    const double* __restrict__ ds, const double* __restrict__ dzl,
    const double* __restrict__ dzu, const uint8_t* __restrict__ ok,
    const double* __restrict__ err_d, const double* __restrict__ err_kkt,
    const double* __restrict__ lbw, const double* __restrict__ ubw,
    double* __restrict__ w_o, double* __restrict__ s_o,
    double* __restrict__ y_o, double* __restrict__ lam_o,
    double* __restrict__ zl_o, double* __restrict__ zu_o,
    double* __restrict__ mu_o, double* __restrict__ err_o,
    int n, int n_eq, int n_ineq, double tau, double kappa_mu, double mu_min) {
  __shared__ double red[K4_THREADS / 32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t on = (size_t)b * n, oe = (size_t)b * n_eq, oi = (size_t)b * n_ineq;
  const double mu_b = mu[b];

  // pass 1: fraction-to-boundary ratios (initial 1.0 as in the JAX ftb)
  double ra = 1.0, rz = 1.0;
  for (int i = tid; i < n; i += K4_THREADS) {
    const double wi = w[on + i], dwi = dw[on + i];
    const double dl = nmax(__dadd_rn(wi, -lbw[i]), 1e-20);
    const double du = nmax(__dadd_rn(ubw[i], -wi), 1e-20);
    ra = nmin(ra, ftb_ratio(dl, dwi, tau));
    ra = nmin(ra, ftb_ratio(du, -dwi, tau));
    rz = nmin(rz, ftb_ratio(nmax(zl[on + i], 1e-300), dzl[on + i], tau));
    rz = nmin(rz, ftb_ratio(nmax(zu[on + i], 1e-300), dzu[on + i], tau));
  }
  for (int i = tid; i < n_ineq; i += K4_THREADS) {
    ra = nmin(ra, ftb_ratio(s[oi + i], ds[oi + i], tau));
    rz = nmin(rz, ftb_ratio(nmax(lam[oi + i], 1e-12), dlam[oi + i], tau));
  }
  const double alpha = nmin(block_min(ra, red), 1.0);
  const double alpha_z = nmin(block_min(rz, red), 1.0);

  // pass 2: updates
  const double ks = 1e10;  // kappa_sigma corridor
  for (int i = tid; i < n; i += K4_THREADS) {
    const double wn = __dadd_rn(w[on + i], __dmul_rn(alpha, dw[on + i]));
    w_o[on + i] = wn;
    const double lb = lbw[i], ub = ubw[i];
    const bool fl = isfinite(lb), fu = isfinite(ub);
    double zln = fl ? __dadd_rn(zl[on + i], __dmul_rn(alpha_z, dzl[on + i])) : 0.0;
    double zun = fu ? __dadd_rn(zu[on + i], __dmul_rn(alpha_z, dzu[on + i])) : 0.0;
    const double dl = nmax(__dadd_rn(wn, -lb), 1e-20);
    const double du = nmax(__dadd_rn(ub, -wn), 1e-20);
    zln = nmin(nmax(zln, __ddiv_rn(mu_b, __dmul_rn(ks, dl))), __ddiv_rn(__dmul_rn(ks, mu_b), dl));
    zun = nmin(nmax(zun, __ddiv_rn(mu_b, __dmul_rn(ks, du))), __ddiv_rn(__dmul_rn(ks, mu_b), du));
    zl_o[on + i] = fl ? zln : 0.0;
    zu_o[on + i] = fu ? zun : 0.0;
  }
  for (int i = tid; i < n_eq; i += K4_THREADS) {
    const double yn = __dadd_rn(y[oe + i], __dmul_rn(alpha, dy[oe + i]));
    y_o[oe + i] = nmin(nmax(yn, -1e10), 1e10);
  }
  for (int i = tid; i < n_ineq; i += K4_THREADS) {
    const double ln = __dadd_rn(lam[oi + i], __dmul_rn(alpha_z, dlam[oi + i]));
    lam_o[oi + i] = nmin(nmax(ln, 1e-16), 1e10);
    const double sn = __dadd_rn(s[oi + i], __dmul_rn(alpha, ds[oi + i]));
    s_o[oi + i] = nmax(sn, 1e-16);
  }
  if (tid == 0) {
    const double mu_new = nmax(nmin(__dmul_rn(kappa_mu, mu_b), __dmul_rn(0.1, err_d[b])), mu_min);
    mu_o[b] = ok[b] ? mu_new : mu_b;
    err_o[b] = err_kkt[b];
  }
}

}  // namespace

extern "C" {

int kkt_assemble_scaled(const void* W, const void* A, const void* Dr,
                        const void* freev, const void* delta, void* Ks,
                        void* kd, int B, int n, int m, void* stream) {
  const int N = n + m;
  dim3 grid((N + K1_ROWS - 1) / K1_ROWS, B);
  kkt_assemble_scaled_kernel<<<grid, K1_THREADS, N * sizeof(float),
                               (cudaStream_t)stream>>>(
      (const float*)W, (const float*)A, (const float*)Dr, (const float*)freev,
      (const double*)delta, (float*)Ks, (float*)kd, n, m);
  return (int)cudaGetLastError();
}

int lu_factor_batched(void* Ks, void* piv, int B, int N, void* stream) {
  lu_factor_kernel<<<B, K2_THREADS, 0, (cudaStream_t)stream>>>(
      (float*)Ks, (int32_t*)piv, N);
  return (int)cudaGetLastError();
}

int lu_solve_batched(const void* lu, const void* piv, const void* kd,
                     const void* v, void* x, int B, int N, void* stream) {
  lu_solve_kernel<<<B, K3_THREADS, N * sizeof(float), (cudaStream_t)stream>>>(
      (const float*)lu, (const int32_t*)piv, (const float*)kd,
      (const float*)v, (float*)x, N);
  return (int)cudaGetLastError();
}

int advance_state(const void* w, const void* s, const void* y, const void* lam,
                  const void* zl, const void* zu, const void* mu,
                  const void* dw, const void* dy, const void* dlam,
                  const void* ds, const void* dzl, const void* dzu,
                  const void* ok, const void* err_d, const void* err_kkt,
                  const void* lbw, const void* ubw, void* w_o, void* s_o,
                  void* y_o, void* lam_o, void* zl_o, void* zu_o, void* mu_o,
                  void* err_o, int B, int n, int n_eq, int n_ineq,
                  double tau, double kappa_mu, double mu_min, void* stream) {
  advance_state_kernel<<<B, K4_THREADS, 0, (cudaStream_t)stream>>>(
      (const double*)w, (const double*)s, (const double*)y,
      (const double*)lam, (const double*)zl, (const double*)zu,
      (const double*)mu, (const double*)dw, (const double*)dy,
      (const double*)dlam, (const double*)ds, (const double*)dzl,
      (const double*)dzu, (const uint8_t*)ok, (const double*)err_d,
      (const double*)err_kkt, (const double*)lbw, (const double*)ubw,
      (double*)w_o, (double*)s_o, (double*)y_o, (double*)lam_o,
      (double*)zl_o, (double*)zu_o, (double*)mu_o, (double*)err_o, n, n_eq,
      n_ineq, tau, kappa_mu, mu_min);
  return (int)cudaGetLastError();
}

}  // extern "C"
