// Hand-written Hopper kernels of the augmented-KKT interior-point direction.
//
// They replace the XLA operations that awebox_tpu/parallel/batch.py runs in
// _auglu_solve (factor='lu') and _advance_state:
//
//   K1 kkt_assemble_scaled   batch.py:333-336, 409-413  assemble K(delta) and
//                            its Jacobi scaling kd, write Ks = kd K kd
//   K2 lu_factor_batched     batch.py:414  partial-pivot LU of Ks (f32), two
//                            variants chosen by N: lu_factor_cluster (a lane
//                            per thread-block cluster, the matrix in shared
//                            memory) and lu_factor_unblocked (a lane per
//                            block, the matrix in global memory)
//   K3 lu_solve_batched      batch.py:416-418  kd * lu_solve(lu, piv, kd * v),
//                            a tiled triangular solve, the factor streamed
//                            through shared memory
//   K4 advance_state         batch.py:449-512  fraction-to-boundary step,
//                            dual safeguards and barrier update (f64)
//
// Layout follows the JAX package: lanes first, row-major. Every entry point
// is a plain C function that returns a CUDA error code; a launch goes to the
// caller's stream and returns cudaGetLastError(). Build (no PyTorch headers):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libauglu.so auglu.cu
//
// Rounding: products and sums that must match the plain PyTorch version
// bit for bit use the __fmul_rn/__fadd_rn (__dmul_rn/__dadd_rn) intrinsics,
// which nvcc never contracts into FMAs. Clamps are written as comparisons
// that let a NaN through, as torch.clamp and jnp.clip do.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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
// K2 semantics, both variants: LAPACK getrf on each lane's row-major N x N
// f32 matrix, in place: unit-lower L below the diagonal, U on and above it,
// 1-based int32 pivots; the pivot is the first row of largest |a_ik| (ties
// keep the lower row, as LAPACK's isamax), and a column of NaNs keeps the
// diagonal. A zero pivot is not clamped: the division makes inf/NaN that
// reach the solution, so the caller's finiteness test fails and the
// regularization ladder retries, as with LAPACK in the JAX package.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void argmax_warp(float& best, int& bidx) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, bidx, off);
    if (ov > best || (ov == best && oi < bidx)) { best = ov; bidx = oi; }
  }
}

// ---------------------------------------------------------------------------
// K2, cluster variant: replaces jax.scipy.linalg.lu_factor at
// awebox_tpu/parallel/batch.py:414 wherever a lane fits a cluster's shared
// memory (N <= ~580, the slice's N = 543 included).
//
// What bounds the unblocked variant below on this card: one SM per lane (16
// of 132 SMs at B = 16, one SM for a one-lane ladder retry) and N^3/3
// read-modify-writes through L2 per lane. Here a lane is one thread-block
// cluster of C <= 8 CTAs on C SMs, whose shared memories together hold the
// whole lane matrix (8 x 215 KB at N = 543): the lane is read from HBM once
// and written once, and every update runs out of shared memory.
//
// Columns are dealt to the CTAs block-cyclically in panels of NB: panel g
// (global columns g*NB ..) lives on CTA g % C as its local panel g / C,
// whole columns (all N rows, column-major, leading dimension ld) in dynamic
// shared memory. Per panel p, right-looking blocked LU:
//   1. the owner factors its NB columns alone, each thread holding its
//      rows of the panel in registers (per column: argmax fused into the
//      previous column's update, two block barriers);
//   2. cluster barrier; every CTA copies the panel's pivots and its rows
//      p0.. (L11 over L21) from the owner's shared memory (DSMEM) into its
//      own L buffer. The owner does not touch the panel's columns again
//      before the next panel's barrier, so one cluster barrier per panel
//      suffices;
//   3. every CTA applies the NB row swaps to all of its columns apart from
//      the panel itself (LAPACK laswp, factored columns included), solves
//      its part of U12 = L11^-1 A12 (a thread per column) and updates
//      A22 -= L21 U12 on its trailing columns with 4x4 register tiles in
//      IEEE f32 FMA on the CUDA cores (no tensor cores: TF32 would be the
//      analog of the TPU's bf16 passes, which did not converge).
// What still bounds it (H100, N = 543, one lane ~0.6 ms): the owner's
// column-by-column panel factor, ~0.3 ms on the critical path while the
// other CTAs wait at the cluster barrier, and the DSMEM copy, ~0.1 ms, in
// which the owner's SM serves all C readers. A look-ahead would overlap the
// factor with the trailing updates (later work).
// Global rows are 4*N bytes apart, 16-byte aligned only when N % 4 == 0,
// so the lane is loaded by 4-byte cp.async (every element of a CTA in
// flight at once; a half-warp covers a 64-byte row segment of a panel) and
// stored by coalesced 4-byte stores. The DSMEM copy and the pivot search
// are latency-bound too: a warp copies one panel column with all of its
// loads issued before its stores, and the argmax reduces by redux.sync.
// ---------------------------------------------------------------------------
constexpr int K2C_THREADS = 512;
constexpr int K2C_WARPS = K2C_THREADS / 32;
constexpr int K2C_NB = 16;
constexpr int K2C_ROWS = 2;           // panel rows a thread holds: N <= 1024
constexpr int K2C_MAX_CLUSTER = 8;    // the portable cluster size
constexpr int K2C_ROWSTEP = K2C_THREADS / K2C_NB;   // rows per pass of the load
static_assert(K2C_WARPS == K2C_NB, "a warp per panel column in the DSMEM copy");

__device__ __forceinline__ void fms4(float4& acc, const float4& l, float u) {
  acc.x -= l.x * u; acc.y -= l.y * u; acc.z -= l.z * u; acc.w -= l.w * u;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// Pivot search by key: |a| as its bits plus one (non-negative floats order
// as their bits, +inf included), 0 for no candidate or NaN, so a NaN is
// never chosen. argmax_redux leaves the warp's largest key in key and the
// lowest row holding it in row (the first maximum, as LAPACK's isamax).
__device__ __forceinline__ unsigned amax_key(float x) {
  const float a = fabsf(x);
  return (a == a) ? __float_as_uint(a) + 1u : 0u;
}

__device__ __forceinline__ void argmax_redux(unsigned& key, int& row) {
  const unsigned m = __reduce_max_sync(0xffffffffu, key);
  row = (int)__reduce_min_sync(0xffffffffu, key == m ? (unsigned)row : 0xffffffffu);
  key = m;
}

// Unblocked LU of the owner's panel: columns P + k*ld (k < w), global rows
// p0..N-1. Each thread holds its rows p0 + tid + s*K2C_THREADS of the panel
// in registers (N - p0 <= K2C_ROWS * K2C_THREADS); per column every warp
// reduces the per-warp argmax slots itself, the owners of rows p and gk
// publish them through s_prow / s_krow, and every row below is scaled and
// updated in registers. Pivots go to s_piv (0-based, read by the cluster)
// and pv.
__device__ void factor_panel(float* __restrict__ P, int ld, int p0, int w, int N,
                             int* s_piv, int32_t* __restrict__ pv, unsigned* s_key,
                             int* s_row, float* s_prow, float* s_krow) {
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  float v[K2C_ROWS][K2C_NB];
  int row[K2C_ROWS];
  unsigned key = 0u;
  int brow = N;
#pragma unroll
  for (int s = 0; s < K2C_ROWS; ++s) {
    row[s] = p0 + tid + s * K2C_THREADS;
#pragma unroll
    for (int c = 0; c < K2C_NB; ++c) {
      v[s][c] = (row[s] < N && c < w) ? P[c * ld + row[s]] : 0.0f;
    }
    if (row[s] < N && amax_key(v[s][0]) > key) { key = amax_key(v[s][0]); brow = row[s]; }
  }
  argmax_redux(key, brow);
  if (wl == 0) { s_key[warp] = key; s_row[warp] = brow; }
#pragma unroll
  for (int k = 0; k < K2C_NB; ++k) {
    if (k < w) {
      const int gk = p0 + k;
      __syncthreads();                  // the slots of column k are in
      key = wl < K2C_WARPS ? s_key[wl] : 0u;
      brow = wl < K2C_WARPS ? s_row[wl] : N;
      argmax_redux(key, brow);
      const int p = key ? brow : gk;    // column of NaNs: keep the diagonal
#pragma unroll
      for (int s = 0; s < K2C_ROWS; ++s) {
        if (row[s] == p) {
#pragma unroll
          for (int c = 0; c < K2C_NB; ++c) s_prow[c] = v[s][c];
        }
        if (row[s] == gk) {
#pragma unroll
          for (int c = 0; c < K2C_NB; ++c) s_krow[c] = v[s][c];
        }
      }
      if (tid == 0) { s_piv[k] = p; pv[gk] = p + 1; }
      __syncthreads();                  // rows p and gk are published
      const float pivot = s_prow[k];
      key = 0u;
      brow = N;
#pragma unroll
      for (int s = 0; s < K2C_ROWS; ++s) {
        if (row[s] == gk) {
#pragma unroll
          for (int c = 0; c < K2C_NB; ++c) v[s][c] = s_prow[c];
        } else if (row[s] == p) {
#pragma unroll
          for (int c = 0; c < K2C_NB; ++c) v[s][c] = s_krow[c];
        }
        if (row[s] > gk && row[s] < N) {
          const float l = v[s][k] / pivot;
          v[s][k] = l;
#pragma unroll
          for (int c = k + 1; c < K2C_NB; ++c) v[s][c] -= l * s_prow[c];
          if (k + 1 < w && amax_key(v[s][k + 1]) > key) { key = amax_key(v[s][k + 1]); brow = row[s]; }
        }
      }
      if (k + 1 < w) {
        argmax_redux(key, brow);
        if (wl == 0) { s_key[warp] = key; s_row[warp] = brow; }
      }
    }
  }
#pragma unroll
  for (int s = 0; s < K2C_ROWS; ++s) {
    if (row[s] < N) {
#pragma unroll
      for (int c = 0; c < K2C_NB; ++c) {
        if (c < w) P[c * ld + row[s]] = v[s][c];
      }
    }
  }
}

__global__ void __launch_bounds__(K2C_THREADS, 1)
lu_factor_cluster_kernel(float* __restrict__ Ks, int32_t* __restrict__ piv,
                         int N, int ld, int cols) {
  extern __shared__ float4 k2c_dyn[];
  __shared__ unsigned s_key[K2C_WARPS];
  __shared__ int s_row[K2C_WARPS];
  __shared__ int s_piv[K2C_NB];   // pivots of the panel this CTA factored last
  __shared__ int s_pl[K2C_NB];    // pivots of the current panel, local copy
  __shared__ float s_prow[K2C_NB], s_krow[K2C_NB];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.dim_blocks().x;
  const int rank = (int)cluster.block_rank();
  const int lane = blockIdx.x / C;
  float* As = reinterpret_cast<float*>(k2c_dyn);   // [cols][ld] this CTA's columns
  float* Ls = As + (size_t)cols * ld;              // [NB][ld] the current L panel
  float* Us = Ls + (size_t)K2C_NB * ld;            // [NB][cols] U12 of this CTA
  float* a = Ks + (size_t)lane * N * N;
  int32_t* pv = piv + (size_t)lane * N;
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int n_panels = (N + K2C_NB - 1) / K2C_NB;
  const int n_local = (n_panels - rank + C - 1) / C;
  const int ncl = n_local * K2C_NB;   // local columns, the last panel padded with zeros
  const int Nr = (N + 3) & ~3;        // rows the 4-row tiles cover
  const int lc = tid % K2C_NB, li = tid / K2C_NB;   // the load's column and first row

  // load: column lp*NB + lc holds global column j; rows N..ld-1 are zero
  for (int lp = 0; lp < n_local; ++lp) {
    const int j = (lp * C + rank) * K2C_NB + lc;
    float* col = As + (size_t)(lp * K2C_NB + lc) * ld;
    for (int i = li; i < ld; i += K2C_ROWSTEP) {
      if (j < N && i < N) {
        cp_async4(col + i, a + (size_t)i * N + j);
      } else {
        col[i] = 0.0f;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  for (int p = 0; p < n_panels; ++p) {
    const int owner = p % C;
    const int lpo = p / C;               // the panel's local index on its owner
    const int p0 = p * K2C_NB;
    const int w = min(K2C_NB, N - p0);
    if (rank == owner) {
      factor_panel(As + (size_t)lpo * K2C_NB * ld, ld, p0, w, N, s_piv, pv, s_key, s_row,
                   s_prow, s_krow);
    }
    cluster.sync();

    // pivots and rows p0..Nr-1 of the panel from the owner's shared memory,
    // a warp per column
    const float* rP = cluster.map_shared_rank(As, owner) + (size_t)lpo * K2C_NB * ld;
    const int* rpiv = cluster.map_shared_rank(s_piv, owner);
    if (tid < w) s_pl[tid] = rpiv[tid];
    if (warp < w) {
      const float4* src = reinterpret_cast<const float4*>(rP + warp * ld);
      float4* dst = reinterpret_cast<float4*>(Ls + warp * ld);
      const int q0 = p0 >> 2, q1 = Nr >> 2;
      float4 r[K2C_ROWS * K2C_THREADS / 128];
#pragma unroll
      for (int s = 0; s < K2C_ROWS * K2C_THREADS / 128; ++s) {
        const int q = q0 + wl + 32 * s;
        if (q < q1) r[s] = src[q];
      }
#pragma unroll
      for (int s = 0; s < K2C_ROWS * K2C_THREADS / 128; ++s) {
        const int q = q0 + wl + 32 * s;
        if (q < q1) dst[q] = r[s];
      }
    }
    __syncthreads();

    // the panel's row swaps on every column held here but the panel itself
    for (int c = tid; c < ncl; c += K2C_THREADS) {
      if (rank == owner && c / K2C_NB == lpo) continue;
      float* col = As + (size_t)c * ld;
      for (int k = 0; k < w; ++k) {
        const int r = s_pl[k];
        if (r != p0 + k) {
          const float t = col[p0 + k];
          col[p0 + k] = col[r];
          col[r] = t;
        }
      }
    }

    // trailing columns: the local panels after panel p (all full width)
    const int lp_start = (p < rank) ? 0 : (p - rank) / C + 1;
    const int c0 = lp_start * K2C_NB;
    const int ntc = ncl - c0;
    if (ntc > 0) {                      // uniform over the CTA
      __syncthreads();
      // U12 = L11^-1 A12, unit lower, a thread per column
      for (int c = tid; c < ntc; c += K2C_THREADS) {
        float* col = As + (size_t)(c0 + c) * ld + p0;
        float u[K2C_NB];
#pragma unroll
        for (int k = 0; k < K2C_NB; ++k) u[k] = col[k];
#pragma unroll
        for (int k = 1; k < K2C_NB; ++k) {
#pragma unroll
          for (int t = 0; t < k; ++t) u[k] -= Ls[t * ld + p0 + k] * u[t];
        }
#pragma unroll
        for (int k = 0; k < K2C_NB; ++k) {
          col[k] = u[k];
          Us[k * cols + c] = u[k];
        }
      }
      __syncthreads();
      // A22 -= L21 U12 on rows p0+NB..Nr-1; consecutive threads take
      // consecutive 4-row groups of one 4-column group
      const int r0 = p0 + K2C_NB;
      const int nrg = (Nr - r0) >> 2, ncg = ntc >> 2;
      for (int t = tid; t < nrg * ncg; t += K2C_THREADS) {
        const int cgi = t / nrg, rg = t - cgi * nrg;
        const int i0 = r0 + 4 * rg, j0 = 4 * cgi;
        float4* dst[4];
        float4 acc[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          dst[c] = reinterpret_cast<float4*>(As + (size_t)(c0 + j0 + c) * ld + i0);
          acc[c] = *dst[c];
        }
#pragma unroll
        for (int k = 0; k < K2C_NB; ++k) {
          const float4 l = *reinterpret_cast<const float4*>(Ls + k * ld + i0);
          const float4 u = *reinterpret_cast<const float4*>(Us + k * cols + j0);
          fms4(acc[0], l, u.x);
          fms4(acc[1], l, u.y);
          fms4(acc[2], l, u.z);
          fms4(acc[3], l, u.w);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) *dst[c] = acc[c];
      }
    }
    __syncthreads();
  }
  cluster.sync();   // no CTA leaves while another may still read its shared memory

  for (int lp = 0; lp < n_local; ++lp) {
    const int j = (lp * C + rank) * K2C_NB + lc;
    if (j >= N) continue;
    const float* col = As + (size_t)(lp * K2C_NB + lc) * ld;
    for (int i = li; i < N; i += K2C_ROWSTEP) a[(size_t)i * N + j] = col[i];
  }
}

// the cluster variant's launch configuration: B clusters of C CTAs
cudaLaunchConfig_t k2c_config(int B, int C, int smem, void* stream,
                              cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(K2C_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// ---------------------------------------------------------------------------
// K2, unblocked variant: right-looking unblocked partial-pivot LU, one
// thread block per lane, for lanes that no cluster's shared memory holds
// (N = 1055 of the n_k = 8 system: 4.45 MB per lane). The matrix stays in
// global memory and is served from L2. Per column: block-wide argmax of
// |a_ik| (warp shuffles, then one shared slot per warp), row swap, column
// scale by division, and a rank-1 update of the trailing block in which
// consecutive threads own consecutive columns (coalesced) and the
// multiplier a_ik is a broadcast load. Bound by the trailing update: about
// N^3/3 read-modify-writes of a 4-byte word through L2 per lane (~0.43 GB
// moved at N = 543), pulled by one SM.
// ---------------------------------------------------------------------------
constexpr int K2_THREADS = 1024;
constexpr int K2_COLS = 128;                 // columns per pass
constexpr int K2_ROWSTEP = K2_THREADS / K2_COLS;

__global__ void __launch_bounds__(K2_THREADS)
lu_factor_unblocked_kernel(float* __restrict__ Ks, int32_t* __restrict__ piv, int N) {
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
    argmax_warp(best, bidx);
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
// K3: x = kd * lu_solve(lu, piv, kd * v), replacing jax.scipy.linalg.lu_solve
// inside ksolve (awebox_tpu/parallel/batch.py:416-418); one CTA of 8 warps
// per lane, any N.
//
// What bounds a triangular solve on this card is its dependent chain, not
// its bytes: one lane's factor (1.18 MB at N = 543) takes 0.35 us of HBM
// time, but a row-by-row solve is 2N dependent block-wide reductions, each
// behind an L2 round trip. This design cuts the chain to 2 ceil(N/32) tile
// steps (34 at N = 543), one block barrier each:
//   - The factor is cut into 32 x 32 tiles. Forward (unit L) runs over
//     column tiles t = 0..T-1, back (U) over t = T-1..0. In step t, warp 0
//     solves the diagonal tile in registers (32 steps of shuffle broadcast
//     and FMA; U's diagonal by its reciprocal, taken off the chain: on the
//     chain an IEEE division cost ~0.8 us a tile). One barrier
//     publishes the 32 values. Warp 0 then applies them to the next tile's
//     rows (look-ahead) and goes on to that diagonal tile, while warps 1-7
//     apply them to the remaining rows below (above, for U) in its shadow:
//     a lane per row, one 128-byte row segment per tile (right-looking).
//   - The factor streams through shared memory ahead of use. Each warp knows
//     the tiles it consumes (warp 0 the diagonal and look-ahead tiles, warp
//     w >= 1 every 7th remaining tile of a step) and keeps its next sw tiles
//     in flight in its own ring of sw slots, a copy issued only once the
//     slot's tile is used (warp 0 refills after its next diagonal solve, so
//     no copy is issued on the chain). Rows are 4N bytes apart,
//     so at odd N a row segment starts anywhere in a 16-byte block and TMA
//     does not apply; the warp copies the aligned 16-byte blocks that cover
//     each segment by cp.async.cg (4-byte copies issued too slowly: with
//     them the loads held the chain back by half its time), and each lane
//     reads its row from its own offset. No load sits on the chain.
//   - The pivots are off the chain: LAPACK's sequential interchanges are
//     composed per chunk of 32 in parallel (each lane traces its row and its
//     pivot row back through the chunk's swaps), then warp 0 applies the
//     ceil(N/32) chunk permutations as gathers, instead of N serial swaps.
// Numerics: IEEE f32 FMA on the CUDA cores; nothing is skipped for a zero
// entry, so a non-finite factor reaches x and the delta ladder retries.
// What still bounds it (H100, N = 543, ~77 us at B = 1 and 16, phase cuts
// of awebox_tpu_torch/probes/solve_phases.py): ~2.3 us a step, of which the
// diagonal chain takes ~0.55; the tile copies cost ~0.65 a step though no
// wait on them is ever taken (they share the memory pipe with the chain's
// shuffles and shared loads), warps 1-7 ~0.25, the barrier ~0.1.
// ---------------------------------------------------------------------------
constexpr int K3_THREADS = 256;
constexpr int K3_WARPS = K3_THREADS / 32;
constexpr int K3_NB = 32;                  // tile width: a warp
constexpr int K3_CHUNKS = K3_NB / 4 + 1;  // aligned 16-byte blocks that cover a row of a tile
constexpr int K3_TILE = 1168;              // floats per ring slot: k3_base(31) + 4 K3_CHUNKS,
                                           // rounded up to 16 bytes
constexpr unsigned K3_FULL = 0xffffffffu;

// The step sequence: step s < T solves column tile s of L, step s >= T
// column tile 2T-1-s of U. Step s has k3_ntiles tiles: index 0 is the
// diagonal tile, 1 the look-ahead tile (the rows solved next), 2.. the rest,
// in the order of the solve. Warp 0 owns indices 0 and 1, warp w >= 1 the
// indices w+1, w+8, ...
__device__ __forceinline__ int k3_ntiles(int s, int T) { return (s < T ? T : 2 * T) - s; }

__device__ __forceinline__ int k3_first(int warp) { return warp == 0 ? 0 : warp + 1; }

__device__ __forceinline__ int k3_stride(int warp) { return warp == 0 ? 1 : K3_WARPS - 1; }

// row tile of index idx of step s (its column tile is the step's)
__device__ __forceinline__ int k3_row_tile(int s, int idx, int T) {
  return s < T ? s + idx : 2 * T - 1 - s - idx;
}

// A warp's walk over its own tiles, in the order it consumes them; s == 2T
// once no tile is left.
struct K3Walk {
  int s, idx;
  __device__ __forceinline__ void settle(int T, int warp) {
    while (s < 2 * T && idx >= (warp == 0 ? min(2, k3_ntiles(s, T)) : k3_ntiles(s, T))) {
      ++s;
      idx = k3_first(warp);
    }
  }
};

// Row r of a tile lives in its slot from k3_base(r) on, as the K3_CHUNKS
// aligned 16-byte blocks that cover it; its first entry sits k3_shift floats
// into the first block. The 4 (r / 8) offset puts the 32 rows' entries k on
// 32 different banks when N is odd (the shift then runs through 0..3 with r).
__device__ __forceinline__ int k3_base(int r) { return r * 4 * K3_CHUNKS + 4 * (r >> 3); }

__device__ __forceinline__ int k3_shift(const float* row) {
  return (int)((uintptr_t)row >> 2) & 3;
}

__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src, bool copy) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(d), "l"(src), "r"(copy ? 16 : 0) : "memory");
}

// A lane's share of every tile copy, computed once: its i-th block is block
// c4[i] / 4 of row r[i] (block q = 32 i + lane of the tile's 32 K3_CHUNKS),
// r[i] N floats into the tile and off[i] floats into the slot.
struct K3Blocks {
  int r[K3_CHUNKS], c4[K3_CHUNKS], rN[K3_CHUNKS], off[K3_CHUNKS];

  __device__ __forceinline__ void init(int N, int wl) {
#pragma unroll
    for (int i = 0; i < K3_CHUNKS; ++i) {
      const int q = i * 32 + wl;
      r[i] = q / K3_CHUNKS;
      c4[i] = 4 * (q - r[i] * K3_CHUNKS);
      rN[i] = r[i] * N;
      off[i] = k3_base(r[i]) + c4[i];
    }
  }
};

// The warp copies tile (ti, tj) of the lane's factor a into slot, one
// 16-byte block per lane and instruction. A block is read only if it holds
// an entry of the tile, so no read leaves the factor's rows; the others,
// rows past N included, are filled with zeros. Entries of the next row that
// share a block with the tile's last columns are zeroed by k3_row.
__device__ __forceinline__ void k3_load(float* slot, const K3Blocks& b,
                                        const float* __restrict__ a, int N, int ti, int tj) {
  const int rows = min(K3_NB, N - ti * K3_NB);
  const int cols = min(K3_NB, N - tj * K3_NB);
  const float* tile = a + (size_t)ti * K3_NB * N + tj * K3_NB;
#pragma unroll
  for (int i = 0; i < K3_CHUNKS; ++i) {
    const float* row = tile + b.rN[i];
    const int shift = k3_shift(row);
    cp_async16_zfill(slot + b.off[i], row - shift + b.c4[i],
                     b.r[i] < rows && b.c4[i] < shift + cols);
  }
}

// The lane's row of tile (ti, tj) in a slot that has landed; the columns
// past N are zeroed (the last column tile only).
__device__ __forceinline__ float* k3_row(float* slot, const float* __restrict__ a, int N,
                                         int ti, int tj, int wl) {
  const float* src = a + (size_t)(ti * K3_NB + wl) * N + tj * K3_NB;
  float* row = slot + k3_base(wl) + k3_shift(src);
  for (int k = N - tj * K3_NB; k < K3_NB; ++k) row[k] = 0.0f;
  return row;
}

// A warp's ring of SW slots over its own tiles: tile k lands in slot k % SW.
// Of the tiles taken, `freed` were given back; giving tile k back issues the
// copy of tile k + SW into its slot, so no copy is issued before a tile is
// used. Each copy is one cp.async group: tile k has landed once at most
// SW - 1 - (taken - freed) groups are pending.
template <int SW>
struct K3Ring {
  float* slots;
  const float* a;
  int N, T, warp, wl;
  K3Walk ahead;
  K3Blocks blocks;
  int taken, freed;

  __device__ __forceinline__ void issue(float* slot) {
    if (ahead.s < 2 * T) {
      k3_load(slot, blocks, a, N, k3_row_tile(ahead.s, ahead.idx, T),
              ahead.s < T ? ahead.s : 2 * T - 1 - ahead.s);
      ahead.idx += k3_stride(warp);
      ahead.settle(T, warp);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  __device__ __forceinline__ void start() {
    blocks.init(N, wl);
    ahead = {0, k3_first(warp)};
    ahead.settle(T, warp);
    taken = freed = 0;
#pragma unroll
    for (int i = 0; i < SW; ++i) issue(slots + i * K3_TILE);
  }

  __device__ __forceinline__ float* take() {
    if (taken == freed) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(SW - 1) : "memory");
    } else {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(SW - 2) : "memory");
    }
    __syncwarp();
    return slots + (taken++ % SW) * K3_TILE;
  }

  __device__ __forceinline__ void give_back_all() {
    __syncwarp();                     // every lane is done with the slots
    while (freed < taken) issue(slots + (freed++ % SW) * K3_TILE);
  }
};

template <int SW>
__global__ void __launch_bounds__(K3_THREADS, 1)
lu_solve_kernel(const float* __restrict__ lu, const int32_t* __restrict__ piv,
                const float* __restrict__ kd, const float* __restrict__ v,
                float* __restrict__ x, int N) {
  extern __shared__ float4 k3_dyn[];
  const int T = (N + K3_NB - 1) / K3_NB;
  const int Np = T * K3_NB;
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  float* y = reinterpret_cast<float*>(k3_dyn) + (size_t)K3_WARPS * SW * K3_TILE;  // [Np]
  int* src_a = reinterpret_cast<int*>(y + Np);   // [Np] row k takes row src_a[k] ...
  int* src_b = src_a + Np;                       // ... and its pivot row dst_b[k]
  int* dst_b = src_b + Np;                       //     row src_b[k], in k's chunk
  const int lane = blockIdx.x;
  const float* a = lu + (size_t)lane * N * N;
  const int32_t* pv = piv + (size_t)lane * N;
  const float* kdl = kd + (size_t)lane * N;

  // the warp's first sw tiles in flight
  K3Ring<SW> ring;
  ring.slots = reinterpret_cast<float*>(k3_dyn) + (size_t)warp * SW * K3_TILE;
  ring.a = a;
  ring.N = N;
  ring.T = T;
  ring.warp = warp;
  ring.wl = wl;
  ring.start();

  // y = P (kd * v): per chunk of 32 interchanges, lane q traces row c0+q and
  // its pivot row back through the chunk's swaps (rows past N swap with
  // themselves); then warp 0 applies the chunks in order as gathers. Two
  // lanes that write one row write the same value.
  for (int i = tid; i < Np; i += K3_THREADS) {
    y[i] = i < N ? __fmul_rn(kdl[i], v[(size_t)lane * N + i]) : 0.0f;
  }
  for (int c = warp; c < T; c += K3_WARPS) {
    const int k = c * K3_NB + wl;
    const int p = k < N ? pv[k] - 1 : k;
    int ra = k, rb = p;
#pragma unroll
    for (int q = K3_NB - 1; q >= 0; --q) {
      const int pq = __shfl_sync(K3_FULL, p, q);
      const int kq = c * K3_NB + q;
      ra = ra == kq ? pq : (ra == pq ? kq : ra);
      rb = rb == kq ? pq : (rb == pq ? kq : rb);
    }
    src_a[k] = ra;
    src_b[k] = rb;
    dst_b[k] = p;
  }
  __syncthreads();
  if (warp == 0) {
    for (int c = 0; c < T; ++c) {
      const int k = c * K3_NB + wl;
      const float va = y[src_a[k]], vb = y[src_b[k]];
      __syncwarp();
      if (k < N) {
        y[k] = va;
        y[dst_b[k]] = vb;
      }
      __syncwarp();
    }
  }

  for (int s = 0; s < 2 * T; ++s) {
    const bool fwd = s < T;
    const int t = fwd ? s : 2 * T - 1 - s;
    const int r0 = t * K3_NB;
    const int w = min(K3_NB, N - r0);
    const int n = k3_ntiles(s, T);
    float yj = 0.0f;                  // warp 0: lane wl's entry of the diagonal tile
    if (warp == 0) {
      const float* D = k3_row(ring.take(), a, N, t, t, wl);
      float d[K3_NB];
#pragma unroll
      for (int k = 0; k < K3_NB; ++k) d[k] = D[k];
      yj = y[r0 + wl];
      // rows past N (lanes >= w of the last tile) hold zeros and meet only
      // zero entries of the tile, so no lane is masked
      if (fwd) {                      // unit lower: y_j -= L_jk y_k, k < j
#pragma unroll
        for (int k = 0; k < K3_NB - 1; ++k) {
          const float yk = __shfl_sync(K3_FULL, yj, k);
          if (wl > k) yj = fmaf(-d[k], yk, yj);
        }
      } else {                        // upper: y_k *= 1/U_kk, then y_j -= U_jk y_k, j < k
        // the reciprocal (IEEE, within an ulp of getrs's division) is taken
        // off the chain, once per lane; rows past N scale their zero by 1
        const float rinv = wl < w ? 1.0f / D[wl] : 1.0f;
#pragma unroll
        for (int k = K3_NB - 1; k >= 0; --k) {
          if (wl == k) yj *= rinv;
          if (k > 0) {
            const float yk = __shfl_sync(K3_FULL, yj, k);
            if (wl < k) yj = fmaf(-d[k], yk, yj);
          }
        }
      }
      if (wl < w) {
        y[r0 + wl] = yj;
      } else {
        yj = 0.0f;                    // rows past N stay zero
      }
      ring.give_back_all();           // this tile and the last look-ahead tile
    }
    __syncthreads();                  // the tile's values are out; every update of step s-1 is in

    if (warp == 0) {
      if (n > 1) {                    // look-ahead: the rows solved next
        const int ti = k3_row_tile(s, 1, T), row = ti * K3_NB + wl;
        const float* M = k3_row(ring.take(), a, N, ti, t, wl);   // given back after
        float acc[4] = {y[row], 0.0f, 0.0f, 0.0f};               // the next diagonal
#pragma unroll
        for (int k = 0; k < K3_NB; ++k) {
          acc[k & 3] = fmaf(-M[k], __shfl_sync(K3_FULL, yj, k), acc[k & 3]);
        }
        if (row < N) y[row] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      }
    } else if (warp + 1 < n) {
      float yt[K3_NB];
#pragma unroll
      for (int k = 0; k < K3_NB; ++k) yt[k] = y[r0 + k];
      for (int idx = warp + 1; idx < n; idx += K3_WARPS - 1) {
        const int ti = k3_row_tile(s, idx, T), row = ti * K3_NB + wl;
        const float* M = k3_row(ring.take(), a, N, ti, t, wl);
        float acc[4] = {y[row], 0.0f, 0.0f, 0.0f};   // four chains of 8 FMAs
#pragma unroll
        for (int k = 0; k < K3_NB; ++k) acc[k & 3] = fmaf(-M[k], yt[k], acc[k & 3]);
        if (row < N) y[row] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
        ring.give_back_all();
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  for (int i = tid; i < N; i += K3_THREADS) {
    x[(size_t)lane * N + i] = __fmul_rn(kdl[i], y[i]);
  }
}

// dynamic shared memory of lu_solve_kernel<sw> at N
constexpr size_t k3_smem(int sw, int N) {
  return sizeof(float) * (size_t)K3_WARPS * sw * K3_TILE
      + 16 * (size_t)((N + K3_NB - 1) / K3_NB * K3_NB);
}

template <int SW>
int k3_launch(const void* lu, const void* piv, const void* kd, const void* v, void* x,
              int B, int N, int smem, void* stream) {
  if ((size_t)smem < k3_smem(SW, N)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute((const void*)lu_solve_kernel<SW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  lu_solve_kernel<SW><<<B, K3_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)lu, (const int32_t*)piv, (const float*)kd, (const float*)v, (float*)x, N);
  return (int)cudaGetLastError();
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

// How many clusters of C CTAs with smem bytes of dynamic shared memory each
// the card runs at once; written to *max_clusters (int).
int lu_factor_cluster_occupancy(int C, int smem, void* max_clusters) {
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)lu_factor_cluster_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = k2c_config(1, C, smem, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(
      (int*)max_clusters, (const void*)lu_factor_cluster_kernel, &cfg);
}

// The layout (C CTAs per lane, cols columns of leading dimension ld per
// CTA, smem bytes of dynamic shared memory) is computed in one place,
// kernels.lu_factor_geometry; only the limits compiled into the kernel
// are checked here.
int lu_factor_cluster(void* Ks, void* piv, int B, int N, int C, int cols,
                      int ld, int smem, void* stream) {
  if (N > K2C_ROWS * K2C_THREADS || C < 1 || C > K2C_MAX_CLUSTER) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)lu_factor_cluster_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = k2c_config(B, C, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, lu_factor_cluster_kernel, (float*)Ks,
                           (int32_t*)piv, N, ld, cols);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int lu_factor_unblocked(void* Ks, void* piv, int B, int N, void* stream) {
  lu_factor_unblocked_kernel<<<B, K2_THREADS, 0, (cudaStream_t)stream>>>(
      (float*)Ks, (int32_t*)piv, N);
  return (int)cudaGetLastError();
}

// sw, the ring slots per warp, and smem, the dynamic shared memory, come
// from kernels.lu_solve_geometry; only that smem covers sw at N is checked.
int lu_solve_batched(const void* lu, const void* piv, const void* kd,
                     const void* v, void* x, int B, int N, int sw, int smem,
                     void* stream) {
  switch (sw) {
    case 5: return k3_launch<5>(lu, piv, kd, v, x, B, N, smem, stream);
    case 2: return k3_launch<2>(lu, piv, kd, v, x, B, N, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
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
