// Hand-written Hopper kernels of the augmented-KKT interior-point direction.
//
// They replace the XLA operations that awebox_tpu/parallel/batch.py runs in
// direction, _auglu_solve (factor='lu') and _advance_state:
//
//   K1 newton_kkt            batch.py:154-180, 320-336, 409-413  the Newton
//                            system, its row equilibration and the scaled
//                            K(delta_w), in two phases: newton_rows (a warp
//                            per constraint row, a thread per variable) and
//                            newton_tiles (32x32 tiles of Ks);
//                            kkt_assemble_scaled runs the same tile kernel
//                            on the lanes a delta-ladder retry assembles
//   K2 lu_factor_batched     batch.py:414  partial-pivot LU of Ks (f32), two
//                            variants chosen by N: lu_factor_cluster (a lane
//                            per thread-block cluster, the matrix in shared
//                            memory) and lu_factor_unblocked (a lane per
//                            block, the matrix in global memory)
//   K3 lu_solve_batched      batch.py:416-418  kd * lu_solve(lu, piv, kd * v),
//                            a tiled triangular solve, the factor streamed
//                            through shared memory
//   K4 ip_step               batch.py:189-198, 449-512  the direction from
//                            the solution (ds, dzl, dzu, err), the
//                            fraction-to-boundary step, dual safeguards and
//                            barrier update (f64)
//
// Layout follows the JAX package: lanes first, row-major. Every entry point
// is a plain C function that returns a CUDA error code; a launch goes to the
// caller's stream and returns cudaGetLastError(). newton_rows, newton_tiles
// and ip_step take their many tensors as one host array of pointers, in the
// order of their structs below (kernels.NEWTON_FIELDS, STEP_FIELDS). Build (no PyTorch headers):
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
#include <string.h>

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// Shared helpers. Clamps and min/max let a NaN through, as torch.clamp,
// torch.minimum and jnp.minimum do (fmin/fmax would drop it).
// ---------------------------------------------------------------------------
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return (x < lo) ? lo : x;  // NaN passes through
}

__device__ __forceinline__ float clamp_hi(float x, float hi) {
  return (x > hi) ? hi : x;  // NaN passes through
}

__device__ __forceinline__ double nmin(double a, double b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

__device__ __forceinline__ double nmax(double a, double b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

// torch.where(torch.isfinite(x), x, 0.): the sanitizing of the derivatives
__device__ __forceinline__ float fin32(float x) { return isfinite(x) ? x : 0.0f; }

__device__ __forceinline__ double fin64(double x) { return isfinite(x) ? x : 0.0; }

// a / b rounded to nearest, as __ddiv_rn, with the operands that send the
// division to its slow path on this card (an infinite or zero operand:
// every unbounded variable has dl = inf) answered inline by IEEE's rules
__device__ __forceinline__ double div_rn(double a, double b) {
  if (isfinite(a) && isfinite(b) && a != 0.0 && b != 0.0) return __ddiv_rn(a, b);
  const unsigned long long sign =
      (unsigned long long)(__double_as_longlong(a) ^ __double_as_longlong(b)) & 0x8000000000000000ull;
  if (a != a || b != b || (isinf(a) && isinf(b)) || (a == 0.0 && b == 0.0)) {
    return __longlong_as_double(0x7ff8000000000000ll);   // NaN
  }
  if (isinf(a) || b == 0.0) return __longlong_as_double((long long)(sign | 0x7ff0000000000000ull));
  return __longlong_as_double((long long)sign);           // a zero or b infinite: a signed zero
}

// K(delta)'s Jacobi factor of one diagonal entry:
// clip(1/sqrt(clip(d, 1e-8)), 0, 1e4) in f32, as kkt_assemble_scaled_plain
__device__ __forceinline__ float jacobi(float d) {
  const float r = 1.0f / sqrtf(clamp_lo(d, 1e-8f));
  return clamp_hi(clamp_lo(r, 0.0f), 1e4f);
}

// ---------------------------------------------------------------------------
// K1 newton_kkt: the barrier-Newton system, its row equilibration and the
// scaled augmented matrix Ks = kd K(delta_w) kd, in one kernel pair. It
// replaces awebox_tpu/parallel/batch.py:154-180 (sanitizing, sigma, W0, A,
// D, r1, r2), :320-331 (row equilibration rn, the f32 casts, D_reg, r2_e,
// b) and :333-336, 409-413 (K(delta) and its Jacobi scaling), and equals the
// plain composition (kernels.newton_kkt_plain) bit for bit: every entry is
// computed in the same order, f64 where the plain code works in f64, then
// rounded once to f32.
//
// What bounds it: bytes. At B=16 it must read JE, JI and H in f32 (9.7 MB)
// and write Ks (18.9 MB) and the f64 images of W0 and A' that the
// refinement reads (19.4 MB): 14.5 us at 3.35 TB/s. A row-per-block
// assembly reads the A'^T block with a stride of n floats across a warp,
// one 32-byte sector per 4-byte entry, and recomputes all N scale factors
// in every block; upstream, the plain composition runs ~75 eager passes
// over O(n^2) f64 data. Here:
//   phase 1 (newton_rows_kernel, grid (row blocks + variable blocks, B)):
//     a warp per constraint row i of [JE; JI] loads the row once, coalesced,
//     into registers: A_ij = fin(J_ij) free_j (written in f64 for the r1
//     product), rn_i = 1 / max_j |A_ij| (warp shuffles), A'_ij = f32(A_ij)
//     rn_i (its f64 image written), D_reg, Dr32, r2_e, b's lower half and
//     kd of the dual rows; a thread per variable j computes sigma_j, W0_jj
//     and kd_j;
//   between the phases the wrapper runs A^T nu as the one batched
//     torch.matmul of the plain version, on phase 1's f64 A: a plain matrix
//     product, which the JAX package too leaves to XLA, and the only way to
//     get cuBLAS's summation order, hence r1, bit for bit;
//   phase 2 (kkt_tiles_kernel, grid (tiles of 32x32, B)): each tile is
//     built straight from H and J (in f32 where free is 0 or 1, which is
//     exact), W0's entries written beside it as f64; the A'^T entries go
//     through a padded shared tile (33 columns), so loads and stores are
//     both coalesced; kd is read once per tile from phase 1; every load of
//     a thread is issued before the tile's one barrier; the tiles of column
//     0 finish r1 and b's upper half.
// Phase 2 needs every kd of its lane and phase 1's A for the product, so
// the phases are two launches: a cluster per lane could share kd through
// DSMEM, but not wait on cuBLAS between them.
// What still bounds it (H100, B=16, phase cuts of
// awebox_tpu_torch/probes/fused_phases.py): the design moves ~73 MB, not
// the 48 MB of the bound, since A is written in f64 for cuBLAS (9.4 MB)
// and read back by it, and J is read by both phases. Phase 1 takes ~10 us
// (its stores ~3); the product ~4.5; phase 2 ~25, of which its stores
// alone ~15-19 and an empty grid of its 4624 blocks ~3.6. Taller tiles
// (64 rows) and fewer resident blocks were slower.
//
// The retry assembly (kkt_assemble_scaled, the delta ladder's lanes) runs
// the same tile kernel on the f32 W0 and A' of the failing lanes, the
// tiles computing their scale factors themselves and those of column 0
// writing kd.
// ---------------------------------------------------------------------------
constexpr int K1_TILE = 32;                     // columns of a tile
constexpr int K1_TROWS_TILE = 32;               // rows of a tile
constexpr int K1_TROWS = 8;                     // thread rows of a tile block
constexpr int K1_THREADS = K1_TILE * K1_TROWS;
constexpr int K1_WARPS = K1_THREADS / 32;       // constraint rows per phase-1 block
constexpr int K1_ROW_REGS = 24;                 // a row's entries per lane: n <= 768
constexpr int K1_MIN_BLOCKS = 8;                // tile blocks an SM holds at once: 32 registers

// Pointers of one newton_kkt call, in the order of kernels.NEWTON_FIELDS
// (lanes first, row-major; lbw, ubw and free are shared by all lanes).
struct NewtonPtrs {
  const float* JE;         // (B, n_eq, n)
  const float* JI;         // (B, n_ineq, n)
  const float* H;          // (B, n, n)
  const double* gradf;     // (B, n)
  const double* cE;        // (B, n_eq)
  const double* cI;        // (B, n_ineq)
  const double* w;         // (B, n)
  const double* s;         // (B, n_ineq)
  const double* y;         // (B, n_eq)
  const double* lam;       // (B, n_ineq)
  const double* zl;        // (B, n)
  const double* zu;        // (B, n)
  const double* mu;        // (B,)
  const double* lbw;       // (n,)
  const double* ubw;       // (n,)
  const double* free;      // (n,)
  float* Ks;               // (B, N, N) out
  float* kd;               // (B, N) out
  double* W64;             // (B, n, n) out: f64 image of f32(W0)
  double* A64;             // (B, m, n) out: f64 image of A' = f32(A) rn
  double* rn;              // (B, m) out
  double* D_reg;           // (B, m) out
  float* Dr32;             // (B, m) out
  double* r2_e;            // (B, m) out
  double* b;               // (B, N) out: [r1, -r2_e]
  double* r1;              // (B, n) out
  double* Araw;            // (B, m, n) scratch: A = [JE; JI] free in f64
  double* nu;              // (B, m) scratch: [y, lam]
  float* diag32;           // (B, n) scratch: f32(W0_jj)
  float* rn32;             // (B, m) scratch: rn in f32
  const double* Atnu;      // (B, n): A^T nu, the wrapper's product
};
static_assert(sizeof(NewtonPtrs) == 31 * sizeof(void*), "NewtonPtrs is an array of pointers");

// A'_rc in f32: f32(fin(J_rc) free_c) rn_r, J = [JE; JI]; where free_c is 1
// or 0 the f64 round trip is exact and skipped
__device__ __forceinline__ float a_prime(const NewtonPtrs& p, int lane, int r, int c, int n,
                                         int n_eq, int n_ineq) {
  const float* J = r < n_eq ? p.JE + ((size_t)lane * n_eq + r) * n
                            : p.JI + ((size_t)lane * n_ineq + (r - n_eq)) * n;
  const float v = fin32(J[c]);
  const double f = p.free[c];
  const float a = f == 1.0 ? v
                : f == 0.0 ? __fmul_rn(v, 0.0f)
                           : __double2float_rn(__dmul_rn((double)v, f));
  return __fmul_rn(a, p.rn32[(size_t)lane * (n_eq + n_ineq) + r]);
}

__global__ void __launch_bounds__(K1_THREADS)
newton_rows_kernel(NewtonPtrs p, int n, int n_eq, int n_ineq, double delta_w, double delta_c) {
  const int lane = blockIdx.y;
  const int m = n_eq + n_ineq, N = n + m;
  const int row_blocks = (m + K1_WARPS - 1) / K1_WARPS;
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const double mu = p.mu[lane];
  if ((int)blockIdx.x < row_blocks) {
    const int i = blockIdx.x * K1_WARPS + warp;   // a warp per constraint row
    if (i >= m) return;
    const float* __restrict__ J = i < n_eq ? p.JE + ((size_t)lane * n_eq + i) * n
                                           : p.JI + ((size_t)lane * n_ineq + (i - n_eq)) * n;
    const size_t orow = ((size_t)lane * m + i) * n;
    // the row's scalars (the same address across the warp) and the row in
    // registers, every load issued before the first store
    const bool eq = i < n_eq;
    const size_t oq = eq ? (size_t)lane * n_eq + i : (size_t)lane * n_ineq + (i - n_eq);
    const double nu = eq ? p.y[oq] : p.lam[oq];
    const double c = eq ? p.cE[oq] : p.cI[oq];
    const double sq = eq ? 0.0 : p.s[oq];
    float v[K1_ROW_REGS];
    double amax = 0.0;
#pragma unroll
    for (int t = 0; t < K1_ROW_REGS; ++t) {
      const int j = wl + 32 * t;
      v[t] = j < n ? fin32(J[j]) : 0.0f;
      if (j < n) amax = nmax(amax, fabs(__dmul_rn((double)v[t], p.free[j])));
    }
    for (int off = 16; off > 0; off >>= 1) {
      amax = nmax(amax, __shfl_xor_sync(FULL_MASK, amax, off));
    }
    // rn = f32(clip(1 / clip(max |A_i.|, 1e-10, 1e10), 0, 1e6))
    const double rinv = __ddiv_rn(1.0, nmin(nmax(amax, 1e-10), 1e10));
    const float rn32 = __double2float_rn(nmin(nmax(rinv, 0.0), 1e6));
#pragma unroll
    for (int t = 0; t < K1_ROW_REGS; ++t) {
      const int j = wl + 32 * t;
      if (j < n) {
        const double a = __dmul_rn((double)v[t], p.free[j]);
        p.Araw[orow + j] = a;
        p.A64[orow + j] = (double)__fmul_rn(__double2float_rn(a), rn32);
      }
    }
    if (wl != 0) return;
    const size_t oi = (size_t)lane * m + i;
    const double rn = (double)rn32;
    double D, r2;
    if (eq) {
      D = delta_c;
      r2 = fin64(c);
    } else {
      const double lam_safe = nmax(nu, 1e-12);
      D = __dadd_rn(div_rn(sq, lam_safe), delta_c);
      r2 = __dadd_rn(fin64(c), div_rn(mu, lam_safe));
    }
    const double r2e = __dmul_rn(r2, rn);
    const double Dreg = __dadd_rn(__dmul_rn(__dmul_rn(D, rn), rn), delta_c);
    const float Dr = __double2float_rn(Dreg);
    p.nu[oi] = nu;
    p.rn[oi] = rn;
    p.rn32[oi] = rn32;
    p.r2_e[oi] = r2e;
    p.D_reg[oi] = Dreg;
    p.Dr32[oi] = Dr;
    p.b[(size_t)lane * N + n + i] = -r2e;
    p.kd[(size_t)lane * N + n + i] = jacobi(Dr);
  } else {
    const int j = (blockIdx.x - row_blocks) * K1_THREADS + tid;   // a thread per variable
    if (j >= n) return;
    const size_t oj = (size_t)lane * n + j;
    const double wj = p.w[oj], fj = p.free[j];
    const double dl = nmax(__dsub_rn(wj, p.lbw[j]), 1e-20);
    const double du = nmax(__dsub_rn(p.ubw[j], wj), 1e-20);
    const double sigma = nmin(nmax(__dadd_rn(div_rn(p.zl[oj], dl), div_rn(p.zu[oj], du)),
                                   0.0), 1e16);
    // W0_jj = (H_jj + sigma_j) free_j free_j + (1 - free_j)
    const double h = (double)fin32(p.H[oj * n + j]);
    const float d32 = __double2float_rn(__dadd_rn(__dmul_rn(__dadd_rn(h, sigma), __dmul_rn(fj, fj)),
                                                  __dsub_rn(1.0, fj)));
    p.diag32[oj] = d32;
    const float kw = __fmul_rn(__double2float_rn(delta_w), __double2float_rn(fj));
    p.kd[(size_t)lane * N + j] = jacobi(fabsf(__fadd_rn(d32, kw)));
  }
}

// Where phase 2 takes its entries: from the Newton system (newton_kkt) ...
struct FusedTiles {
  NewtonPtrs p;
  int n, n_eq, n_ineq;
  float d32;   // f32(delta_w)

  __device__ __forceinline__ float delta(int) const { return d32; }
  __device__ __forceinline__ float free32(int i) const { return __double2float_rn(p.free[i]); }
  __device__ __forceinline__ float kd(int lane, int i) const {
    return p.kd[(size_t)lane * (n + n_eq + n_ineq) + i];
  }
  __device__ __forceinline__ float dr(int lane, int r) const {
    return p.Dr32[(size_t)lane * (n_eq + n_ineq) + r];
  }
  __device__ __forceinline__ float a(int lane, int r, int c) const {
    return a_prime(p, lane, r, c, n, n_eq, n_ineq);
  }
  // f32(W0_ij); W0 = (H + diag sigma) (free free^T) + diag(1 - free), the
  // diagonal from phase 1. Off it, f32((f64(h) + 0) ff + 0) with ff =
  // free_i free_j is h + 0 (which turns -0 into +0) where ff is 1 and +0
  // where ff is 0, exactly: the f64 round trip only for other free values
  __device__ __forceinline__ float w(int lane, int i, int j) const {
    if (i == j) return p.diag32[(size_t)lane * n + i];
    const float h = fin32(p.H[((size_t)lane * n + i) * n + j]);
    const double ff = __dmul_rn(p.free[i], p.free[j]);
    if (ff == 1.0) return __fadd_rn(h, 0.0f);
    if (ff == 0.0) return 0.0f;
    return __double2float_rn(__dadd_rn(__dmul_rn(__dadd_rn((double)h, 0.0), ff), 0.0));
  }
  // the f64 image of W0 that the refinement reads
  __device__ __forceinline__ void w_out(int lane, int i, int j, float v) const {
    p.W64[((size_t)lane * n + i) * n + j] = (double)v;
  }
  // the tiles of column 0: r1 = -(gradf + A^T nu - mu/dl + mu/du) free and
  // b's upper half, for the tile's rows i0 ..
  __device__ __forceinline__ void finish(int lane, int i0, const float*) const {
    const int i = i0 + (int)threadIdx.x;
    if (threadIdx.x >= K1_TROWS_TILE || i >= n) return;
    const size_t oi = (size_t)lane * n + i;
    const double mu = p.mu[lane], wi = p.w[oi];
    const double dl = nmax(__dsub_rn(wi, p.lbw[i]), 1e-20);
    const double du = nmax(__dsub_rn(p.ubw[i], wi), 1e-20);
    const double g = __dadd_rn(__dsub_rn(__dadd_rn(fin64(p.gradf[oi]), p.Atnu[oi]),
                                         div_rn(mu, dl)), div_rn(mu, du));
    const double r1 = __dmul_rn(-g, p.free[i]);
    p.r1[oi] = r1;
    p.b[(size_t)lane * (n + n_eq + n_ineq) + i] = r1;
  }
};

// ... or from the f32 W0 and A' of the lanes a ladder retry assembles
struct RetryTiles {
  const float* W;       // (B, n, n)
  const float* A;       // (B, m, n)
  const float* Dr;      // (B, m)
  const float* fr;      // (n,)
  const double* dl;     // (B,) the lanes' delta
  float* kd_out;        // (B, N)
  int n, m;

  __device__ __forceinline__ float delta(int lane) const { return __double2float_rn(dl[lane]); }
  __device__ __forceinline__ float free32(int i) const { return fr[i]; }
  __device__ __forceinline__ float kd(int lane, int i) const {
    const float d = i < n ? fabsf(__fadd_rn(W[((size_t)lane * n + i) * n + i],
                                            __fmul_rn(delta(lane), fr[i])))
                          : dr(lane, i - n);
    return jacobi(d);
  }
  __device__ __forceinline__ float dr(int lane, int r) const { return Dr[(size_t)lane * m + r]; }
  __device__ __forceinline__ float a(int lane, int r, int c) const {
    return A[((size_t)lane * m + r) * n + c];
  }
  __device__ __forceinline__ float w(int lane, int i, int j) const {
    return W[((size_t)lane * n + i) * n + j];
  }
  __device__ __forceinline__ void w_out(int, int, int, float) const {}
  // the tiles of column 0 write kd of their rows
  __device__ __forceinline__ void finish(int lane, int i0, const float* kdr) const {
    const int i = i0 + (int)threadIdx.x;
    if (threadIdx.x < K1_TROWS_TILE && i < n + m) kd_out[(size_t)lane * (n + m) + i] = kdr[threadIdx.x];
  }
};

// Ks = kd K(delta) kd, one tile of K1_TROWS_TILE rows and 32 columns per
// block (grid (tiles, lanes)); thread (tx, ty) holds column tx of the tile
// rows ty, ty + 8, ...
template <class Src>
__global__ void __launch_bounds__(K1_THREADS, K1_MIN_BLOCKS)
kkt_tiles_kernel(Src src, float* __restrict__ Ks, int n, int m) {
  constexpr int TR = K1_TROWS_TILE, R = TR / K1_TROWS;
  __shared__ float at[K1_TILE][TR + 1];   // A'^T entries of the tile, transposed
  __shared__ float kdr[TR], kdc[K1_TILE];
  const int N = n + m, TC = (N + K1_TILE - 1) / K1_TILE;
  const int lane = blockIdx.y, ti = blockIdx.x / TC, tj = blockIdx.x % TC;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int i0 = ti * TR, j0 = tj * K1_TILE;
  for (int r = threadIdx.x; r < TR; r += K1_THREADS) {
    if (i0 + r < N) kdr[r] = src.kd(lane, i0 + r);
  }
  if (ty == K1_TROWS - 1 && j0 + tx < N) kdc[tx] = src.kd(lane, j0 + tx);
  if (i0 < n && j0 + K1_TILE > n) {   // the tile holds A'^T entries: rows < n, columns >= n
    for (int k = ty; k < K1_TILE; k += K1_TROWS) {
      const int col = j0 + k;   // A' row col - n, columns i0 + c: coalesced over tx
#pragma unroll
      for (int c = tx; c < TR; c += 32) {
        if (col >= n && col < N && i0 + c < n) at[k][c] = src.a(lane, col - n, i0 + c);
      }
    }
  }
  // the thread's own entries, loaded in the same round as the shared ones
  // (before the barrier)
  const int j = j0 + tx;
  float w[R], k[R];
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const int i = i0 + ty + K1_TROWS * t;
    w[t] = 0.0f;
    k[t] = 0.0f;
    if (i < N && j < N) {
      if (i < n) {
        if (j < n) {   // W0 + delta diag(free)
          w[t] = src.w(lane, i, j);
          k[t] = __fadd_rn(w[t], __fmul_rn(src.delta(lane), i == j ? src.free32(i) : 0.0f));
        }
      } else if (j < n) {
        k[t] = src.a(lane, i - n, j);
      } else {
        k[t] = (i == j) ? -src.dr(lane, i - n) : -0.0f;
      }
    }
  }
  __syncthreads();
  if (tj == 0) src.finish(lane, i0, kdr);
  if (j >= N) return;
  float* Kl = Ks + (size_t)lane * N * N;
  const float kdj = kdc[tx];
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const int r = ty + K1_TROWS * t, i = i0 + r;
    if (i < N) {
      if (i < n && j >= n) k[t] = at[tx][r];
      Kl[(size_t)i * N + j] = __fmul_rn(__fmul_rn(k[t], kdr[r]), kdj);
      if (i < n && j < n) src.w_out(lane, i, j, w[t]);
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
// K4 ip_step: the direction from the solution and the interior-point step,
// f64, one kernel. It replaces awebox_tpu/parallel/batch.py:189-198 (the ok
// sanitizing, dy/dlam, ds = -(cI + s) - JI dw, dzl, dzu, err_d, err_p) and
// _advance_state, :449-512 (fraction-to-boundary step, dual safeguards and
// the barrier update), and computes what kernels.ip_step_plain computes: the
// same f64 operations in the same order, but for JI dw, which sums in
// another order than cuBLAS.
//
// What bounds it: latency and the launch, not bytes (~70 KB per lane at
// B=16, 0.2 us of HBM time). A step kernel alone runs after ~30 eager
// PyTorch ops, and one in two passes re-reads the lane's vectors from
// global memory, with two block reductions of three barriers each. Here one
// CTA of 16 warps per lane issues every load of its variables and duals
// first, into registers (K4_ITEMS each a thread), and forms dl, du, the
// directions and the ratios once; a warp per inequality row forms JI dw in
// f64 by shuffles from its own dw entries, so nothing waits on a barrier
// before the one reduction: alpha, alpha_z, err_d and err_p in one round of
// warp shuffles and one barrier. Unbounded variables have dl = du = inf,
// and an f64 division by inf takes the slow path of the division: div_rn
// answers those operands inline (it halved the kernel, 14.5 -> 7.1 us on
// the H100 at B=16; phase cuts of awebox_tpu_torch/probes/fused_phases.py).
// What still bounds it there: the one round of loads and pass 1 ~2.5 us,
// JI dw ~1, the divisions ~1.2, the updates ~1.5, the launch ~0.9.
// ---------------------------------------------------------------------------
constexpr int K4_THREADS = 512;
constexpr int K4_WARPS = K4_THREADS / 32;
constexpr int K4_ITEMS = 2;   // variables (and duals) per thread: n, m <= 1024

// Pointers of one ip_step call, in the order of kernels.STEP_FIELDS.
struct StepPtrs {
  const double* x;         // (B, N): the solution [dw'; dnu'] of the scaled system
  const uint8_t* ok;       // (B,) bool
  const double* rn;        // (B, m)
  const double* r1;        // (B, n)
  const double* cE;        // (B, n_eq)
  const double* cI;        // (B, n_ineq)
  const float* JI;         // (B, n_ineq, n)
  const double* w;         // (B, n)
  const double* s;         // (B, n_ineq)
  const double* y;         // (B, n_eq)
  const double* lam;       // (B, n_ineq)
  const double* zl;        // (B, n)
  const double* zu;        // (B, n)
  const double* mu;        // (B,)
  const double* lbw;       // (n,)
  const double* ubw;       // (n,)
  const double* free;      // (n,)
  double* w_o;             // the new state, shaped as its inputs
  double* s_o;
  double* y_o;
  double* lam_o;
  double* zl_o;
  double* zu_o;
  double* mu_o;
  double* err_o;
  double* ds_o;            // (B, n_ineq) or null: the step's ds, for checks
};
static_assert(sizeof(StepPtrs) == 26 * sizeof(void*), "StepPtrs is an array of pointers");

// -tau * val / dval where dval < 0, else +inf (the ftb ratio)
__device__ __forceinline__ double ftb_ratio(double val, double dval, double tau) {
  return (dval < 0.0) ? div_rn(__dmul_rn(-tau, val), dval) : INFINITY;
}

__global__ void __launch_bounds__(K4_THREADS)
ip_step_kernel(StepPtrs p, int n, int n_eq, int n_ineq, double tau, double kappa_mu,
               double mu_min) {
  extern __shared__ double ds_s[];   // [n_ineq]
  __shared__ double red[4][K4_WARPS];
  const int lane = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int m = n_eq + n_ineq, N = n + m;
  const size_t on = (size_t)lane * n, om = (size_t)lane * m;
  const size_t oe = (size_t)lane * n_eq, oi = (size_t)lane * n_ineq;
  const double* xl = p.x + (size_t)lane * N;
  const double mu = p.mu[lane];
  const bool ok = p.ok[lane] != 0;
  double ra = 1.0, rz = 1.0, err_d = 0.0, err_p = 0.0;   // ftb starts its min at 1

  // every load of the thread's variables and duals first, then the arithmetic
  double wv[K4_ITEMS], xv[K4_ITEMS], fv[K4_ITEMS], lbv[K4_ITEMS], ubv[K4_ITEMS], zlv[K4_ITEMS],
      zuv[K4_ITEMS], r1v[K4_ITEMS];
  double rnv[K4_ITEMS], xnv[K4_ITEMS], cv[K4_ITEMS], yv[K4_ITEMS], sv[K4_ITEMS], lamv[K4_ITEMS];
#pragma unroll
  for (int t = 0; t < K4_ITEMS; ++t) {
    const int i = tid + t * K4_THREADS;
    if (i < n) {
      wv[t] = p.w[on + i]; xv[t] = xl[i]; fv[t] = p.free[i]; lbv[t] = p.lbw[i];
      ubv[t] = p.ubw[i]; zlv[t] = p.zl[on + i]; zuv[t] = p.zu[on + i]; r1v[t] = p.r1[on + i];
    }
    if (i < m) {
      rnv[t] = p.rn[om + i]; xnv[t] = xl[n + i];
      if (i < n_eq) {
        cv[t] = p.cE[oe + i]; yv[t] = p.y[oe + i];
      } else {
        const int q = i - n_eq;
        cv[t] = p.cI[oi + q]; sv[t] = p.s[oi + q]; lamv[t] = p.lam[oi + q];
      }
    }
  }

  // the variables: dw, dzl, dzu and their ratios, err_d
  double dwv[K4_ITEMS], dzlv[K4_ITEMS], dzuv[K4_ITEMS];
#pragma unroll
  for (int t = 0; t < K4_ITEMS; ++t) {
    const int i = tid + t * K4_THREADS;
    if (i < n) {
      double dw = __dmul_rn(xv[t], fv[t]);
      dw = (ok && isfinite(dw)) ? dw : 0.0;
      const double zl = zlv[t], zu = zuv[t];
      const double dl = nmax(__dsub_rn(wv[t], lbv[t]), 1e-20);
      const double du = nmax(__dsub_rn(ubv[t], wv[t]), 1e-20);
      const double dzl = __dsub_rn(__dsub_rn(div_rn(mu, dl), zl), div_rn(__dmul_rn(zl, dw), dl));
      const double dzu = __dadd_rn(__dsub_rn(div_rn(mu, du), zu), div_rn(__dmul_rn(zu, dw), du));
      dwv[t] = dw; dzlv[t] = dzl; dzuv[t] = dzu;
      ra = nmin(ra, ftb_ratio(dl, dw, tau));
      ra = nmin(ra, ftb_ratio(du, -dw, tau));
      rz = nmin(rz, ftb_ratio(nmax(zl, 1e-300), dzl, tau));
      rz = nmin(rz, ftb_ratio(nmax(zu, 1e-300), dzu, tau));
      err_d = nmax(err_d, fabs(r1v[t]));
    }
  }
  // the duals: dnu = rn x[n:], dy and dlam, the lam ratios, err_p
  double dnuv[K4_ITEMS];
#pragma unroll
  for (int t = 0; t < K4_ITEMS; ++t) {
    const int k = tid + t * K4_THREADS;
    if (k < m) {
      double d = __dmul_rn(rnv[t], xnv[t]);
      d = (ok && isfinite(d)) ? d : 0.0;
      dnuv[t] = d;
      if (k < n_eq) {
        err_p = nmax(err_p, fabs(fin64(cv[t])));
      } else {
        rz = nmin(rz, ftb_ratio(nmax(lamv[t], 1e-12), d, tau));
        err_p = nmax(err_p, fabs(__dadd_rn(fin64(cv[t]), sv[t])));
      }
    }
  }
  // ds = -(cI + s) - JI dw, a warp per inequality row, each forming the dw
  // entries it needs from x itself, so no barrier waits for them
  for (int q = warp; q < n_ineq; q += K4_WARPS) {
    const float* J = p.JI + (oi + q) * n;
    double acc = 0.0;
#pragma unroll 8
    for (int j = wl; j < n; j += 32) {
      double dw = __dmul_rn(xl[j], p.free[j]);
      dw = (ok && isfinite(dw)) ? dw : 0.0;
      acc = fma((double)fin32(J[j]), dw, acc);
    }
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(FULL_MASK, acc, off);
    if (wl == 0) {
      const double sq = p.s[oi + q];
      const double ds = __dsub_rn(-__dadd_rn(fin64(p.cI[oi + q]), sq), acc);
      ds_s[q] = ds;
      if (p.ds_o) p.ds_o[oi + q] = ds;
      ra = nmin(ra, ftb_ratio(sq, ds, tau));
    }
  }

  // alpha, alpha_z, err_d, err_p over the lane: warp shuffles, one barrier
  for (int off = 16; off > 0; off >>= 1) {
    ra = nmin(ra, __shfl_xor_sync(FULL_MASK, ra, off));
    rz = nmin(rz, __shfl_xor_sync(FULL_MASK, rz, off));
    err_d = nmax(err_d, __shfl_xor_sync(FULL_MASK, err_d, off));
    err_p = nmax(err_p, __shfl_xor_sync(FULL_MASK, err_p, off));
  }
  if (wl == 0) {
    red[0][warp] = ra;
    red[1][warp] = rz;
    red[2][warp] = err_d;
    red[3][warp] = err_p;
  }
  __syncthreads();   // the warps' partials and ds are in shared memory
#pragma unroll
  for (int v = 0; v < K4_WARPS; ++v) {
    ra = nmin(ra, red[0][v]);
    rz = nmin(rz, red[1][v]);
    err_d = nmax(err_d, red[2][v]);
    err_p = nmax(err_p, red[3][v]);
  }
  const double alpha = nmin(ra, 1.0), alpha_z = nmin(rz, 1.0);

  // the updates
  const double ks = 1e10;   // kappa_sigma corridor
#pragma unroll
  for (int t = 0; t < K4_ITEMS; ++t) {
    const int i = tid + t * K4_THREADS;
    if (i < n) {
      const double wn = __dadd_rn(wv[t], __dmul_rn(alpha, dwv[t]));
      p.w_o[on + i] = wn;
      const double lb = lbv[t], ub = ubv[t];
      const bool fl = isfinite(lb), fu = isfinite(ub);
      double zln = fl ? __dadd_rn(zlv[t], __dmul_rn(alpha_z, dzlv[t])) : 0.0;
      double zun = fu ? __dadd_rn(zuv[t], __dmul_rn(alpha_z, dzuv[t])) : 0.0;
      const double dl = nmax(__dsub_rn(wn, lb), 1e-20);
      const double du = nmax(__dsub_rn(ub, wn), 1e-20);
      zln = nmin(nmax(zln, div_rn(mu, __dmul_rn(ks, dl))), div_rn(__dmul_rn(ks, mu), dl));
      zun = nmin(nmax(zun, div_rn(mu, __dmul_rn(ks, du))), div_rn(__dmul_rn(ks, mu), du));
      p.zl_o[on + i] = fl ? zln : 0.0;
      p.zu_o[on + i] = fu ? zun : 0.0;
    }
  }
#pragma unroll
  for (int t = 0; t < K4_ITEMS; ++t) {
    const int k = tid + t * K4_THREADS;
    if (k < n_eq) {
      const double yn = __dadd_rn(yv[t], __dmul_rn(alpha, dnuv[t]));
      p.y_o[oe + k] = nmin(nmax(yn, -1e10), 1e10);
    } else if (k < m) {
      const int q = k - n_eq;
      const double ln = __dadd_rn(lamv[t], __dmul_rn(alpha_z, dnuv[t]));
      p.lam_o[oi + q] = nmin(nmax(ln, 1e-16), 1e10);
      const double sn = __dadd_rn(sv[t], __dmul_rn(alpha, ds_s[q]));
      p.s_o[oi + q] = nmax(sn, 1e-16);
    }
  }
  if (tid == 0) {
    const double mu_new = nmax(nmin(__dmul_rn(kappa_mu, mu), __dmul_rn(0.1, err_d)), mu_min);
    p.mu_o[lane] = ok ? mu_new : mu;
    p.err_o[lane] = nmax(err_d, err_p);
  }
}

// The launch floor: an empty kernel, timed by chip_smoke.py beside K1-K4.
__global__ void noop_kernel() {}

}  // namespace

extern "C" {

// kernels.NEWTON_FIELDS pointers, in order, as a host array
int newton_rows(const void* const* ptrs, int B, int n, int n_eq, int n_ineq, double delta_w,
                double delta_c, void* stream) {
  if (n > 32 * K1_ROW_REGS) return (int)cudaErrorInvalidValue;
  NewtonPtrs p;
  memcpy(&p, ptrs, sizeof p);
  const int m = n_eq + n_ineq;
  const dim3 grid((m + K1_WARPS - 1) / K1_WARPS + (n + K1_THREADS - 1) / K1_THREADS, B);
  newton_rows_kernel<<<grid, K1_THREADS, 0, (cudaStream_t)stream>>>(p, n, n_eq, n_ineq, delta_w,
                                                                     delta_c);
  return (int)cudaGetLastError();
}

// after newton_rows and the product Atnu = A^T nu on phase 1's A
int newton_tiles(const void* const* ptrs, int B, int n, int n_eq, int n_ineq, double delta_w,
                 void* stream) {
  FusedTiles src;
  memcpy(&src.p, ptrs, sizeof src.p);
  src.n = n;
  src.n_eq = n_eq;
  src.n_ineq = n_ineq;
  src.d32 = (float)delta_w;
  const int N = n + n_eq + n_ineq;
  const dim3 grid(((N + K1_TROWS_TILE - 1) / K1_TROWS_TILE) * ((N + K1_TILE - 1) / K1_TILE), B);
  kkt_tiles_kernel<FusedTiles><<<grid, K1_THREADS, 0, (cudaStream_t)stream>>>(
      src, src.p.Ks, n, n_eq + n_ineq);
  return (int)cudaGetLastError();
}

int kkt_assemble_scaled(const void* W, const void* A, const void* Dr,
                        const void* freev, const void* delta, void* Ks,
                        void* kd, int B, int n, int m, void* stream) {
  const RetryTiles src = {(const float*)W, (const float*)A, (const float*)Dr,
                          (const float*)freev, (const double*)delta, (float*)kd, n, m};
  const int N = n + m;
  const dim3 grid(((N + K1_TROWS_TILE - 1) / K1_TROWS_TILE) * ((N + K1_TILE - 1) / K1_TILE), B);
  kkt_tiles_kernel<RetryTiles><<<grid, K1_THREADS, 0, (cudaStream_t)stream>>>(
      src, (float*)Ks, n, m);
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

// kernels.STEP_FIELDS pointers, in order, as a host array (ds_o may be null)
int ip_step(const void* const* ptrs, int B, int n, int n_eq, int n_ineq, double tau,
            double kappa_mu, double mu_min, void* stream) {
  if (n > K4_ITEMS * K4_THREADS || n_eq + n_ineq > K4_ITEMS * K4_THREADS) {
    return (int)cudaErrorInvalidValue;
  }
  StepPtrs p;
  memcpy(&p, ptrs, sizeof p);
  const size_t smem = sizeof(double) * (size_t)n_ineq;
  ip_step_kernel<<<B, K4_THREADS, smem, (cudaStream_t)stream>>>(p, n, n_eq, n_ineq, tau,
                                                                kappa_mu, mu_min);
  return (int)cudaGetLastError();
}

int noop(int blocks, void* stream) {
  noop_kernel<<<blocks, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
