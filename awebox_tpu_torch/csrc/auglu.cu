// Hand-written Hopper kernels of the augmented-KKT interior-point direction.
//
// They replace the XLA operations that awebox_tpu/parallel/batch.py runs in
// direction, _auglu_solve (factor='lu' and factor='qr', stateless) and
// _advance_state:
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
//                            memory) and lu_factor_blocked (the lane in
//                            global memory, a panel factor per lane and the
//                            trailing updates spread over many CTAs)
//   K3 lu_solve_batched      batch.py:416-418  kd * lu_solve(lu, piv, kd * v),
//                            a tiled triangular solve, the factor streamed
//                            through shared memory
//   K4 ip_step               batch.py:189-198, 449-512  the direction from
//                            the solution (ds, dzl, dzu, err), the
//                            fraction-to-boundary step, dual safeguards and
//                            barrier update (f64)
//   K1, unscaled             batch.py:333-336  the same tile kernel writing
//                            K(delta) itself (no Jacobi scale, no kd) for
//                            the QR factor: newton_tiles with scaled = 0,
//                            kkt_assemble_scaled with a null kd
//   K5 ruiz_scale            batch.py:375-381  three Ruiz sweeps, M = s K s, in one
//                            launch: a thread-block cluster per lane, the
//                            sweeps exchanging s through distributed
//                            shared memory
//   K6 qr_factor_batched     batch.py:382  Householder QR of M (f32) in
//                            LAPACK's geqrf layout, two variants chosen by
//                            N: qr_factor_cluster (a lane per thread-block
//                            cluster, the matrix in shared memory) and
//                            qr_factor_blocked (the lane in global memory,
//                            as K2's blocked variant)
//   K7 qr_solve_batched      batch.py:344-346  R^-1 Q^T v: the reflectors
//                            applied 32 at a time, then a tiled back
//                            substitution
//
// and, f64, those of the block and condensed KKT modes (make_ip_step with
// kkt='block' or 'dense'):
//
//   K4 advance_state         batch.py:449-512  the step half of ip_step, from
//                            a direction the caller computed
//   K8 block_factor          ocp/blockkkt.py:539-588  the two-level Cholesky
//                            of the per-interval frames and the reduced
//                            bordered system: a thread-block cluster per
//                            lane, a CTA per frame, R gathered through
//                            distributed shared memory
//   K9 block_solve           ocp/blockkkt.py:646-679  the structured solve
//                            through K8's factor
//   K10 chol_factor_batched  batch.py:215-231  Cholesky of the condensed M,
//                            two variants chosen by n: chol_factor_cluster
//                            (a lane per thread-block cluster, the lower
//                            triangle in shared memory, the trailing update
//                            by f64 MMAs) and chol_factor_global (a CTA a
//                            lane, the lane in global memory)
//   K11 chol_solve_batched   batch.py:234-236  the two triangular solves
//
// and, f64, those of the host solver's dense direction (opti/ipsolver.py
// kkt_solve, behind Trial.optimize):
//
//   K12 lu_factor_f64        ipsolver.py:194  partial-pivot LU of the
//                            augmented KKT matrix (K2's blocked design)
//   K13 lu_solve_f64         ipsolver.py:195, 197  the interchanges, the
//                            unit-lower and the upper substitution
//
// Layout follows the JAX package: lanes first, row-major. Every entry point
// is a plain C function that returns a CUDA error code; a launch goes to the
// caller's stream and returns cudaGetLastError(). newton_rows, newton_tiles,
// ip_step and advance_state take their many tensors as one host array of
// pointers, in the order of their structs below (kernels.NEWTON_FIELDS,
// STEP_FIELDS, ADVANCE_FIELDS). Build (no PyTorch headers):
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
#include <stddef.h>
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
  float* Ks;               // (B, N, N) out: kd K(delta_w) kd, or K(delta_w) where kd is null
  float* kd;               // (B, N) out, or null for the unscaled K
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
    if (p.kd) p.kd[(size_t)lane * N + n + i] = jacobi(Dr);   // null: the unscaled K
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
    if (p.kd) {
      const float kw = __fmul_rn(__double2float_rn(delta_w), __double2float_rn(fj));
      p.kd[(size_t)lane * N + j] = jacobi(fabsf(__fadd_rn(d32, kw)));
    }
  }
}

// Where phase 2 takes its entries: from the Newton system (newton_kkt) ...
struct FusedTiles {
  NewtonPtrs p;
  int n, n_eq, n_ineq;
  float d32;   // f32(delta_w)

  __device__ __forceinline__ float delta(int) const { return d32; }
  __device__ __forceinline__ float free32(int i) const { return __double2float_rn(p.free[i]); }
  // the unscaled K (p.kd null) multiplies by 1, which is exact
  __device__ __forceinline__ float kd(int lane, int i) const {
    return p.kd ? p.kd[(size_t)lane * (n + n_eq + n_ineq) + i] : 1.0f;
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
  float* kd_out;        // (B, N), or null for the unscaled K
  int n, m;

  __device__ __forceinline__ float delta(int lane) const { return __double2float_rn(dl[lane]); }
  __device__ __forceinline__ float free32(int i) const { return fr[i]; }
  __device__ __forceinline__ float kd(int lane, int i) const {
    if (!kd_out) return 1.0f;
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
    if (kd_out && threadIdx.x < K1_TROWS_TILE && i < n + m) {
      kd_out[(size_t)lane * (n + m) + i] = kdr[threadIdx.x];
    }
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

// ---------------------------------------------------------------------------
// K2, cluster variant: replaces jax.scipy.linalg.lu_factor at
// awebox_tpu/parallel/batch.py:414 wherever a lane fits a cluster's shared
// memory (N <= ~580, the slice's N = 543 included).
//
// What bounds a one-block-per-lane LU on this card: one SM per lane
// (16 of 132 SMs at B = 16, one SM for a one-lane ladder retry) and N^3/3
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

// the same in f64 (K12): a 64-bit key, reduced by xor shuffles since
// redux.sync takes 32 bits
__device__ __forceinline__ unsigned long long amax_key(double x) {
  const double a = fabs(x);
  return (a == a) ? (unsigned long long)__double_as_longlong(a) + 1ull : 0ull;
}

__device__ __forceinline__ void argmax_redux(unsigned long long& key, int& row) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long k2 = __shfl_xor_sync(FULL_MASK, key, off);
    const int r2 = __shfl_xor_sync(FULL_MASK, row, off);
    if (k2 > key || (k2 == key && r2 < row)) {
      key = k2;
      row = r2;
    }
  }
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
// K2, blocked variant: replaces jax.scipy.linalg.lu_factor at
// awebox_tpu/parallel/batch.py:414 for lanes that no cluster's shared memory
// holds (N = 1055 of the n_k = 8 system: 4.45 MB a lane). LAPACK getrf's
// right-looking blocked LU on the lane in global memory, in panels of
// KB_NB = 32 columns, three launches a panel:
//   1. lu_panel_kernel, one CTA of 32 warps per lane: the panel's rows
//      k0..N-1 (135 KB at N = 1055, column-major at an odd leading
//      dimension, so a warp's row of 32 columns hits 32 banks) are factored
//      in shared memory column by column with the pivot rule of both
//      variants. Per column: the 32 warps' argmax slots reduced by
//      redux.sync, warp 0 swaps the panel's rows p and k and publishes the
//      pivot row, every thread scales and updates rows of the panel and
//      finds its candidate of the next column (two block barriers a column).
//      The pivots go to piv;
//   2. lu_swap_kernel, grid (strips of KB_SCOLS columns, B): the panel's
//      interchanges on every other column, composed first into at most
//      2 KB_NB row moves (a thread per column issues all its loads before
//      its stores), and on the trailing columns U12 = L11^-1 A12 (a thread
//      per column, L11 in shared memory);
//   3. lu_update_kernel, grid (KB_TR x KB_TC tiles of A22, B): A22 -= L21
//      U12, each tile staging its rows of L21 and its columns of U12 in
//      shared memory, each thread updating an 8 x 2 register tile.
// What bounds it: 2/3 N^3 f32 operations, 0.78 GFLOP a lane at N = 1055,
// which the whole card does in 23 us at B = 2; a one-block-per-lane kernel
// pulls N^3/3 read-modify-writes through L2 with one SM per lane. Here the
// trailing updates spread over the card and the critical path
// is the chain of panel factors: N columns, each two block barriers and a
// pass over the panel's rows in shared memory, on one SM per lane.
// A few launches a panel, not one persistent kernel: a persistent kernel
// needs a grid-wide barrier between the phases of a panel (three a panel),
// which costs about what a launch on the stream does, and holds every SM for
// the lane's whole chain; with launches the stream orders the phases and each
// phase gets the grid it needs.
// Numerics: IEEE f32 FMA on the CUDA cores, no tensor cores (TF32, the analog
// of the TPU's bf16 passes, did not converge); every sum runs in a fixed
// order and nothing is atomic, so a lane's bits do not depend on the batch.
// ---------------------------------------------------------------------------
constexpr int KB_NB = 32;                     // panel width
constexpr int KB_THREADS = 1024;              // panel kernels: a warp per panel column
constexpr int KB_WARPS = KB_THREADS / 32;
constexpr int KB_SCOLS = 128;                 // columns of a swap strip, a thread each
constexpr int KB_TR = 64;                     // rows of an update tile
constexpr int KB_TC = 64;                     // columns of an update tile
constexpr int KB_LDL = KB_TR + 4;             // row stride of a staged L21 (V) tile
constexpr int KB_UTHREADS = 256;              // update kernels: 32 columns x 8 row groups
static_assert(KB_WARPS == KB_NB, "a warp per panel column, an argmax slot per warp");
static_assert(KB_UTHREADS == 32 * 8 && KB_TR == 8 * 8 && KB_TC == 2 * 32, "8 x 2 register tiles");

// The blocked trio is a template on the element type T and the panel width
// NB (its panel kernel has NB warps): K2 instantiates it at (float, 32), K12
// at (double, 16). What differs by type is below: the FMA, the pivot key
// (amax_key and argmax_redux have a double overload) and the 8-wide load.
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// l[0..7] = p[0..7] from 16-byte aligned shared memory
__device__ __forceinline__ void load8(const float* __restrict__ p, float (&l)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  l[0] = a.x; l[1] = a.y; l[2] = a.z; l[3] = a.w;
  l[4] = b.x; l[5] = b.y; l[6] = b.z; l[7] = b.w;
}

__device__ __forceinline__ void load8(const double* __restrict__ p, double (&l)[8]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const double2 v = *reinterpret_cast<const double2*>(p + 2 * q);
    l[2 * q] = v.x;
    l[2 * q + 1] = v.y;
  }
}

// A[r0 + i][c0 + j] -= sum_k Ls[k][i] Us[k][j] for the tile's rows i < nr and
// columns j < nc, k = 0 .. NB - 1 in order (the k past a narrower last
// panel hold zeros on both sides, so they add 0 * 0): thread (tx, ty) of
// 32 x 8 updates rows 8 ty .. 8 ty + 7 and columns tx, tx + 32 in registers;
// its rows of Ls are 16-byte broadcasts, its columns of Us two
// conflict-free loads a step. The sum is taken from 0 and subtracted once,
// as a GEMM does: accumulated into A itself, a diagonal entry of U would
// take one rounding per column of L (N of them) instead of one per panel.
template <typename T, int NB>
__device__ __forceinline__ void kb_rank_update(T* __restrict__ a, int N, int r0, int c0, int nr,
                                               int nc, const T* __restrict__ Ls,
                                               const T* __restrict__ Us) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  T old[8][2], acc[8][2];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = 8 * ty + p, j = tx + 32 * q;
      old[p][q] = (i < nr && j < nc) ? a[(size_t)(r0 + i) * N + c0 + j] : T(0);
      acc[p][q] = T(0);
    }
  }
#pragma unroll (NB / 4)
  for (int k = 0; k < NB; ++k) {
    T l[8];
    load8(Ls + k * KB_LDL + 8 * ty, l);
    const T u[2] = {Us[k * KB_TC + tx], Us[k * KB_TC + tx + 32]};
#pragma unroll
    for (int p = 0; p < 8; ++p) {
#pragma unroll
      for (int q = 0; q < 2; ++q) acc[p][q] = fma_t(l[p], u[q], acc[p][q]);
    }
  }
#pragma unroll
  for (int p = 0; p < 8; ++p) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = 8 * ty + p, j = tx + 32 * q;
      if (i < nr && j < nc) a[(size_t)(r0 + i) * N + c0 + j] = old[p][q] - acc[p][q];
    }
  }
}

// rows k0..N-1 of the panel's NB columns into P (column c, row k0 + r at
// c * lds + r; columns past the panel's w hold zeros), NB consecutive
// threads a row
template <typename T, int NB, int THREADS>
__device__ __forceinline__ void kb_load_panel(T* __restrict__ P, const T* __restrict__ a, int N,
                                              int k0, int w, int lds) {
  for (int e = threadIdx.x; e < (N - k0) * NB; e += THREADS) {
    const int r = e / NB, c = e % NB;
    P[c * lds + r] = c < w ? a[(size_t)(k0 + r) * N + k0 + c] : T(0);
  }
}

template <typename T, int NB, int THREADS>
__device__ __forceinline__ void kb_store_panel(const T* __restrict__ P, T* __restrict__ a, int N,
                                               int k0, int w, int lds) {
  for (int e = threadIdx.x; e < (N - k0) * NB; e += THREADS) {
    const int r = e / NB, c = e % NB;
    if (c < w) a[(size_t)(k0 + r) * N + k0 + c] = P[c * lds + r];
  }
}

template <typename T, int NB>
__global__ void __launch_bounds__(NB * 32, 1)
lu_panel_kernel(T* __restrict__ Ks, int32_t* __restrict__ piv, int N, int k0, int lds) {
  constexpr int THREADS = NB * 32;            // a warp per panel column, an argmax slot each
  using Key = decltype(amax_key(T(0)));
  extern __shared__ __align__(16) unsigned char lu_dyn[];
  T* P = reinterpret_cast<T*>(lu_dyn);        // [NB][lds] the panel's rows k0..N-1
  __shared__ Key s_key[NB];
  __shared__ int s_row[NB];
  __shared__ T s_prow[NB];                    // the pivot row of the current column
  T* a = Ks + (size_t)blockIdx.x * N * N;
  int32_t* pv = piv + (size_t)blockIdx.x * N;
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int w = min(NB, N - k0), rows = N - k0;
  kb_load_panel<T, NB, THREADS>(P, a, N, k0, w, lds);
  __syncthreads();
  // rows are local (k0 + r global); a thread visits its rows in increasing
  // order and keeps the first of equal keys, the reduction keeps the lowest row
  Key key = 0;
  int brow = N;
  for (int r = tid; r < rows; r += THREADS) {
    const Key kk = amax_key(P[r]);
    if (kk > key) { key = kk; brow = r; }
  }
  argmax_redux(key, brow);
  if (wl == 0) { s_key[warp] = key; s_row[warp] = brow; }
  for (int k = 0; k < w; ++k) {
    __syncthreads();                          // the slots of column k are in
    key = wl < NB ? s_key[wl] : Key(0);
    brow = wl < NB ? s_row[wl] : N;
    argmax_redux(key, brow);
    const int p = key ? brow : k;             // a column of NaNs keeps the diagonal
    if (warp == 0 && wl < NB) {               // rows k and p swap across the panel
      const T vp = P[wl * lds + p], vk = P[wl * lds + k];
      s_prow[wl] = vp;
      P[wl * lds + k] = vp;
      P[wl * lds + p] = vk;
      if (wl == 0) pv[k0 + k] = k0 + p + 1;   // LAPACK's 1-based convention
    }
    __syncthreads();                          // the pivot row is published
    const T pivot = s_prow[k];
    key = 0;
    brow = N;
    for (int r = k + 1 + tid; r < rows; r += THREADS) {
      const T l = P[k * lds + r] / pivot;
      P[k * lds + r] = l;
      for (int c = k + 1; c < w; ++c) P[c * lds + r] = fma_t(-l, s_prow[c], P[c * lds + r]);
      if (k + 1 < w) {
        const Key kk = amax_key(P[(k + 1) * lds + r]);
        if (kk > key) { key = kk; brow = r; }
      }
    }
    if (k + 1 < w) {                          // uniform over the block
      argmax_redux(key, brow);
      if (wl == 0) { s_key[warp] = key; s_row[warp] = brow; }
    }
  }
  __syncthreads();
  kb_store_panel<T, NB, THREADS>(P, a, N, k0, w, lds);
}

// The panel's interchanges on every column outside it (columns j < k0 and
// j >= k0 + w, a thread each), then U12 = L11^-1 A12 on the trailing ones.
// LAPACK's w sequential swaps of rows k0 + q and p_q move at most 2 w rows:
// destination d takes the row found by tracing d back through the swaps,
// from the last one, so every source is loaded before any row is stored.
template <typename T, int NB>
__global__ void __launch_bounds__(KB_SCOLS)
lu_swap_kernel(T* __restrict__ Ks, const int32_t* __restrict__ piv, int N, int k0) {
  __shared__ int s_piv[NB];                   // the panel's pivots, 0-based
  __shared__ int s_dst[2 * NB], s_src[2 * NB];
  __shared__ T L11[NB][NB + 1];               // strictly lower, zeros elsewhere
  T* a = Ks + (size_t)blockIdx.y * N * N;
  const int tid = threadIdx.x;
  const int w = min(NB, N - k0);
  if (tid < w) s_piv[tid] = piv[(size_t)blockIdx.y * N + k0 + tid] - 1;
  for (int e = tid; e < NB * NB; e += KB_SCOLS) {
    const int i = e / NB, t = e % NB;
    L11[i][t] = (i < w && t < i) ? a[(size_t)(k0 + i) * N + k0 + t] : T(0);
  }
  __syncthreads();
  if (tid < 2 * w) {
    const int d = tid < w ? k0 + tid : s_piv[tid - w];
    int r = d;
    for (int q = w - 1; q >= 0; --q) {
      const int pq = s_piv[q];
      r = (r == k0 + q) ? pq : (r == pq ? k0 + q : r);
    }
    s_dst[tid] = d;
    s_src[tid] = r;
  }
  __syncthreads();
  const int c = blockIdx.x * KB_SCOLS + tid;
  if (c >= N - w) return;
  const int j = c < k0 ? c : c + w;
  T v[2 * NB];
#pragma unroll
  for (int d = 0; d < 2 * NB; ++d) v[d] = d < 2 * w ? a[(size_t)s_src[d] * N + j] : T(0);
#pragma unroll
  for (int d = 0; d < 2 * NB; ++d) {
    if (d < 2 * w) a[(size_t)s_dst[d] * N + j] = v[d];
  }
  if (j < k0) return;
  // rows k0..k0+w-1 of the column after the interchanges are v[0..w-1]
#pragma unroll
  for (int k = 1; k < NB; ++k) {
#pragma unroll
    for (int t = 0; t < k; ++t) v[k] = fma_t(-L11[k][t], v[t], v[k]);
  }
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    if (k < w) a[(size_t)(k0 + k) * N + j] = v[k];
  }
}

// A22 -= L21 U12 on the trailing rows and columns k0 + w .. N-1
template <typename T, int NB>
__global__ void __launch_bounds__(KB_UTHREADS)
lu_update_kernel(T* __restrict__ Ks, int N, int k0) {
  __shared__ __align__(16) T Ls[NB * KB_LDL];   // [k][i] L21 of the tile's rows
  __shared__ __align__(16) T Us[NB * KB_TC];    // [k][j] U12 of the tile's columns
  T* a = Ks + (size_t)blockIdx.y * N * N;
  const int tid = threadIdx.x;
  const int w = min(NB, N - k0), t0 = k0 + w;
  const int tiles_c = (N - t0 + KB_TC - 1) / KB_TC;
  const int r0 = t0 + (blockIdx.x / tiles_c) * KB_TR, c0 = t0 + (blockIdx.x % tiles_c) * KB_TC;
  const int nr = min(KB_TR, N - r0), nc = min(KB_TC, N - c0);
  for (int e = tid; e < NB * KB_TR; e += KB_UTHREADS) {   // consecutive threads read a row
    const int i = e / NB, k = e % NB;
    Ls[k * KB_LDL + i] = (i < nr && k < w) ? a[(size_t)(r0 + i) * N + k0 + k] : T(0);
  }
  for (int e = tid; e < NB * KB_TC; e += KB_UTHREADS) {
    const int k = e / KB_TC, j = e % KB_TC;
    Us[e] = (k < w && j < nc) ? a[(size_t)(k0 + k) * N + c0 + j] : T(0);
  }
  __syncthreads();
  kb_rank_update<T, NB>(a, N, r0, c0, nr, nc, Ls, Us);
}

// The host side of the trio: ceil(N / NB) panels, each its three launches
// on the stream. lds (the panel's odd leading dimension, >= N) and smem (the
// panel kernel's dynamic shared memory) come from kernels.py; only that
// they cover the panel is checked.
template <typename T, int NB>
int lu_blocked_launch(T* a, int32_t* pv, int B, int N, int lds, int smem, cudaStream_t st) {
  if (lds < N || lds % 2 == 0 || (size_t)smem < sizeof(T) * NB * (size_t)lds) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute((const void*)lu_panel_kernel<T, NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  for (int k0 = 0; k0 < N; k0 += NB) {
    const int w = min(NB, N - k0), nt = N - k0 - w;
    lu_panel_kernel<T, NB><<<B, NB * 32, smem, st>>>(a, pv, N, k0, lds);
    if (N > w) {
      lu_swap_kernel<T, NB><<<dim3((N - w + KB_SCOLS - 1) / KB_SCOLS, B), KB_SCOLS, 0, st>>>(
          a, pv, N, k0);
    }
    if (nt > 0) {
      const int tiles = ((nt + KB_TR - 1) / KB_TR) * ((nt + KB_TC - 1) / KB_TC);
      lu_update_kernel<T, NB><<<dim3(tiles, B), KB_UTHREADS, 0, st>>>(a, N, k0);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
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

// The step rule of _advance_state (awebox_tpu/parallel/batch.py:449-512),
// shared by ip_step_kernel and advance_state_kernel: a variable's ratios into
// the step's minima ra (primal) and rz (dual), a variable's update, a row's
// updates and the barrier update, each in the plain version's order.
__device__ __forceinline__ void var_ratios(double dl, double du, double dw, double zl, double zu,
                                           double dzl, double dzu, double tau, double& ra,
                                           double& rz) {
  ra = nmin(ra, ftb_ratio(dl, dw, tau));
  ra = nmin(ra, ftb_ratio(du, -dw, tau));
  rz = nmin(rz, ftb_ratio(nmax(zl, 1e-300), dzl, tau));
  rz = nmin(rz, ftb_ratio(nmax(zu, 1e-300), dzu, tau));
}

// the lam ratio of an inequality row
__device__ __forceinline__ double lam_ratio(double lam, double dlam, double tau) {
  return ftb_ratio(nmax(lam, 1e-12), dlam, tau);
}

// the minima ra, rz and (with K = 4) the maxima err_d, err_p over the lane's
// CTA: warp shuffles, one barrier; minima and maxima are exact in any order
template <int K>
__device__ __forceinline__ void lane_reduce(double (&v)[K], double (*red)[K4_WARPS]) {
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const double o = __shfl_xor_sync(FULL_MASK, v[k], off);
      v[k] = k < 2 ? nmin(v[k], o) : nmax(v[k], o);
    }
  }
  if (wl == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[k][warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < K4_WARPS; ++w) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = k < 2 ? nmin(v[k], red[k][w]) : nmax(v[k], red[k][w]);
  }
}

// w + alpha dw, and the bound duals stepped by alpha_z and held in the
// kappa_sigma corridor around mu / (w - lb) and mu / (ub - w)
__device__ __forceinline__ void update_var(double w, double dw, double zl, double dzl, double zu,
                                           double dzu, double lb, double ub, double alpha,
                                           double alpha_z, double mu, double* w_o, double* zl_o,
                                           double* zu_o) {
  const double ks = 1e10;   // kappa_sigma corridor
  const double wn = __dadd_rn(w, __dmul_rn(alpha, dw));
  *w_o = wn;
  const bool fl = isfinite(lb), fu = isfinite(ub);
  double zln = fl ? __dadd_rn(zl, __dmul_rn(alpha_z, dzl)) : 0.0;
  double zun = fu ? __dadd_rn(zu, __dmul_rn(alpha_z, dzu)) : 0.0;
  const double dl = nmax(__dsub_rn(wn, lb), 1e-20);
  const double du = nmax(__dsub_rn(ub, wn), 1e-20);
  zln = nmin(nmax(zln, div_rn(mu, __dmul_rn(ks, dl))), div_rn(__dmul_rn(ks, mu), dl));
  zun = nmin(nmax(zun, div_rn(mu, __dmul_rn(ks, du))), div_rn(__dmul_rn(ks, mu), du));
  *zl_o = fl ? zln : 0.0;
  *zu_o = fu ? zun : 0.0;
}

__device__ __forceinline__ double update_y(double y, double dy, double alpha) {
  return nmin(nmax(__dadd_rn(y, __dmul_rn(alpha, dy)), -1e10), 1e10);
}

__device__ __forceinline__ double update_lam(double lam, double dlam, double alpha_z) {
  return nmin(nmax(__dadd_rn(lam, __dmul_rn(alpha_z, dlam)), 1e-16), 1e10);
}

__device__ __forceinline__ double update_s(double s, double ds, double alpha) {
  return nmax(__dadd_rn(s, __dmul_rn(alpha, ds)), 1e-16);
}

// the barrier update; a lane whose solve failed keeps its mu
__device__ __forceinline__ double update_mu(double mu, double err_d, bool ok, double kappa_mu,
                                            double mu_min) {
  return ok ? nmax(nmin(__dmul_rn(kappa_mu, mu), __dmul_rn(0.1, err_d)), mu_min) : mu;
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
      var_ratios(dl, du, dw, zl, zu, dzl, dzu, tau, ra, rz);
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
        rz = nmin(rz, lam_ratio(lamv[t], d, tau));
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

  // alpha, alpha_z, err_d, err_p over the lane; after its barrier ds is in
  // shared memory
  double v[4] = {ra, rz, err_d, err_p};
  lane_reduce(v, red);
  const double alpha = nmin(v[0], 1.0), alpha_z = nmin(v[1], 1.0);

  // the updates
#pragma unroll
  for (int t = 0; t < K4_ITEMS; ++t) {
    const int i = tid + t * K4_THREADS;
    if (i < n) {
      update_var(wv[t], dwv[t], zlv[t], dzlv[t], zuv[t], dzuv[t], lbv[t], ubv[t], alpha, alpha_z,
                 mu, p.w_o + on + i, p.zl_o + on + i, p.zu_o + on + i);
    }
  }
#pragma unroll
  for (int t = 0; t < K4_ITEMS; ++t) {
    const int k = tid + t * K4_THREADS;
    if (k < n_eq) {
      p.y_o[oe + k] = update_y(yv[t], dnuv[t], alpha);
    } else if (k < m) {
      const int q = k - n_eq;
      p.lam_o[oi + q] = update_lam(lamv[t], dnuv[t], alpha_z);
      p.s_o[oi + q] = update_s(sv[t], ds_s[q], alpha);
    }
  }
  if (tid == 0) {
    p.mu_o[lane] = update_mu(mu, v[2], ok, kappa_mu, mu_min);
    p.err_o[lane] = nmax(v[2], v[3]);
  }
}

// ---------------------------------------------------------------------------
// K5 ruiz_scale: three Ruiz sweeps from s = 1 and the scaled matrix,
// replacing awebox_tpu/parallel/batch.py:375-381:
//   rr_i = sqrt(clip(max_j |M_ij|, 1e-12)),  s_i <- s_i / rr_i,
//   M_ij <- (K_ij s_i) s_j,
// all f32, and equal to kernels.ruiz_scale_plain bit for bit: the maximum is
// exact in any order, the two products of an entry are rounded one after the
// other, the square root and the division are IEEE. A NaN in a row passes
// through the maximum (max.NaN) and the clip into that row's s, as jnp.max
// and jnp.clip pass it; a warp owns a whole row, so it reaches no other
// lane's s.
//
// What bounds it: bytes. The function reads K once and writes M once (37.7 MB
// at N = 543, B = 16: 11 us at 3.35 TB/s), but every sweep needs all of the
// lane's s of the sweep before. One launch does the whole function:
//   - a thread-block cluster of C CTAs per lane, the clusters persistent
//     over lanes (cluster c takes lanes c, c + clusters, ..); CTA rank r owns
//     the R contiguous rows r R .. r R + R - 1 of its lane;
//   - the CTA's first `res` rows are one contiguous run of K, copied into
//     its shared memory once by bulk copies (the TMA, completing on an
//     mbarrier) of the aligned 16-byte blocks that cover it: rows are 4N
//     bytes apart, so at odd N the run starts anywhere in a 16-byte block,
//     and the copy keeps that shift;
//   - where shared memory holds fewer (N = 1055: 53 of a CTA's 66 rows,
//     4.45 MB a lane), the instance for N <= 32 K5_REG_COLS holds up to
//     K5_REG_ROWS more rows a warp in registers (at one CTA an SM a thread
//     has 168), loaded once while the bulk copy runs; rows beyond both
//     (N > 1056 only) are re-read from global memory each sweep, and the
//     wrapper caps the clusters in flight so that those rows stay in the L2;
//   - a warp sweeps up to K5_GROUP of its rows together, so that one load
//     of s_j serves them all, and a butterfly of six shuffles reduces their
//     maxima;
//   - after each sweep a CTA leaves its rows' s in its shared memory, one
//     buffer of two by the sweep's parity, then one cluster barrier, and
//     every CTA gathers the lane's whole s from the C ranks through
//     distributed shared memory;
//   - after the third sweep each warp stores its rows of M as it computes
//     them.
// Where every row is on chip, HBM and the L2 see K once and M once.
// What still bounds it (H100, queued; awebox_tpu_torch/probes/ruiz_phases.py
// cuts): at N = 543 B = 16, 0.031 ms against the 0.011 bound, of which the
// cluster launch ~6 us and the three exchanges ~3.5 us; a cluster cannot
// overlap its lane's load, sweeps and stores, which at B = 128 the 21
// clusters that run at once do for each other (0.17 ms against 0.09). A
// lane has C SMs' bandwidth only: at N = 1055, where 7 clusters fit the
// card, the previous four-launch kernel (every SM on every lane) stays
// faster below B ~ 12 (B = 2: 0.023 against 0.039 ms).
// ---------------------------------------------------------------------------
constexpr int K5_THREADS = 384;
constexpr int K5_WARPS = K5_THREADS / 32;
constexpr int K5_SWEEPS = 3;
constexpr int K5_MAX_CLUSTER = 16;    // a non-portable cluster size
constexpr int K5_GROUP = 4;           // rows a warp sweeps together
constexpr int K5_REG_ROWS = 2;        // rows a warp may hold in registers ...
constexpr int K5_REG_COLS = 33;       // ... of N <= 32 K5_REG_COLS columns
constexpr unsigned K5_CHUNK = 16384;  // bytes a bulk copy moves at most
constexpr int K5_UNROLL = 2;          // column steps a row loop unrolls (56 registers) ...
constexpr int K5_UNROLL_REG = 4;      // ... and in the instance with rows in registers

// max with jnp.max's NaN rule: a NaN in either operand gives a NaN
__device__ __forceinline__ float nmaxf(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__host__ __device__ constexpr int k5_pad4(int x) { return (x + 3) & ~3; }

// Dynamic shared memory, in floats: the lane's s (N), this CTA's s in two
// buffers (2 R), the resident rows with room for the 16-byte blocks that
// cover them (res N + 8). kernels.ruiz_smem computes the same.
__host__ __device__ constexpr size_t k5_smem(int N, int R, int res) {
  return sizeof(float) * ((size_t)k5_pad4(N) + 2 * (size_t)k5_pad4(R) + (size_t)res * N + 8);
}

// whether a layout takes the instance with rows in registers
__host__ __device__ constexpr bool k5_registers(int N, int R, int res) {
  return res < R && N <= 32 * K5_REG_COLS;
}

__device__ __forceinline__ unsigned k5_saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, in bulk copies that complete on mbar (one thread)
__device__ __forceinline__ void k5_bulk_load(float* dst, const float* src, unsigned bytes,
                                             uint64_t* mbar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(k5_saddr(mbar)), "r"(bytes) : "memory");
  for (unsigned o = 0; o < bytes; o += K5_CHUNK) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(k5_saddr(dst) + o), "l"(reinterpret_cast<const char*>(src) + o),
          "r"(min(K5_CHUNK, bytes - o)), "r"(k5_saddr(mbar)) : "memory");
  }
}

__device__ __forceinline__ void k5_wait(uint64_t* mbar, unsigned phase) {
  unsigned done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(k5_saddr(mbar)), "r"(phase) : "memory");
  }
}

// the rows a warp takes together from row r on (every K5_WARPS-th below end)
__device__ __forceinline__ int k5_group_rows(int r, int end, int most) {
  return max(0, min(most, (end - r + K5_WARPS - 1) / K5_WARPS));
}

// A warp's K5_GROUP row maxima, each lane holding a partial of every row,
// reduced by a butterfly; lane 8 q then leaves row q's s, s_i / sqrt(clip(
// max, 1e-12)), in own[r + q K5_WARPS] (q < nq).
__device__ __forceinline__ void k5_finish(const float (&mx)[K5_GROUP],
                                          const float (&si)[K5_GROUP], int nq, float* own,
                                          int r, int wl) {
  const bool hi = wl & 16, odd = wl & 8;
  float a0 = hi ? mx[2] : mx[0], a1 = hi ? mx[3] : mx[1];
  a0 = nmaxf(a0, __shfl_xor_sync(FULL_MASK, hi ? mx[0] : mx[2], 16));
  a1 = nmaxf(a1, __shfl_xor_sync(FULL_MASK, hi ? mx[1] : mx[3], 16));
  float m = odd ? a1 : a0;                    // row 2 hi + odd
  m = nmaxf(m, __shfl_xor_sync(FULL_MASK, odd ? a0 : a1, 8));
  for (int off = 4; off > 0; off >>= 1) m = nmaxf(m, __shfl_xor_sync(FULL_MASK, m, off));
  const int q = wl >> 3;
  const float sq = q == 0 ? si[0] : q == 1 ? si[1] : q == 2 ? si[2] : si[3];
  if ((wl & 7) == 0 && q < nq) {
    own[r + q * K5_WARPS] = __fdiv_rn(sq, __fsqrt_rn(clamp_lo(m, 1e-12f)));
  }
}

// the s_i of a warp's nq rows from r on (1 in the first sweep)
template <bool FIRST>
__device__ __forceinline__ void k5_row_s(float (&si)[K5_GROUP], int nq, int i,
                                         const float* __restrict__ s_all) {
#pragma unroll
  for (int q = 0; q < K5_GROUP; ++q) si[q] = (FIRST || q >= nq) ? 1.0f : s_all[i + q * K5_WARPS];
}

// One sweep over rows [first, end) of the CTA (its row r at rows + r N):
// each warp's groups of rows r, r + K5_WARPS, ..; in the first sweep s = 1,
// so the products are the entries
template <bool FIRST, int U>
__device__ __forceinline__ void k5_sweep(const float* __restrict__ rows, int first, int end,
                                         int r0, const float* __restrict__ s_all, float* own,
                                         int N, int warp, int wl) {
  const size_t stride = (size_t)K5_WARPS * N;
  for (int r = first + warp; r < end; r += K5_WARPS * K5_GROUP) {
    const int nq = k5_group_rows(r, end, K5_GROUP);
    const float* row = rows + (size_t)r * N;
    float si[K5_GROUP], mx[K5_GROUP] = {0.0f, 0.0f, 0.0f, 0.0f};
    k5_row_s<FIRST>(si, nq, r0 + r, s_all);
#pragma unroll U
    for (int j = wl; j < N; j += 32) {
      const float sj = FIRST ? 1.0f : s_all[j];
#pragma unroll
      for (int q = 0; q < K5_GROUP; ++q) {
        if (q < nq) {
          const float v = row[q * stride + j];
          mx[q] = nmaxf(mx[q], fabsf(FIRST ? v : __fmul_rn(__fmul_rn(v, si[q]), sj)));
        }
      }
    }
    k5_finish(mx, si, nq, own, r, wl);
  }
}

// M's rows [first, end) of the CTA from rows (row r at rows + r N) to out
// (row r at out + r N), each warp storing its rows as it computes them
// (4-byte stores: 16-byte stores of the aligned blocks, and staging M in
// shared memory for bulk stores, both ran slower)
template <int U>
__device__ __forceinline__ void k5_write(const float* __restrict__ rows, float* __restrict__ out,
                                         int first, int end, int r0,
                                         const float* __restrict__ s_all, int N, int warp,
                                         int wl) {
  const size_t stride = (size_t)K5_WARPS * N;
  for (int r = first + warp; r < end; r += K5_WARPS * K5_GROUP) {
    const int nq = k5_group_rows(r, end, K5_GROUP);
    float si[K5_GROUP];
    k5_row_s<false>(si, nq, r0 + r, s_all);
#pragma unroll U
    for (int j = wl; j < N; j += 32) {
      const float sj = s_all[j];
#pragma unroll
      for (int q = 0; q < K5_GROUP; ++q) {
        if (q < nq) {
          out[(size_t)r * N + q * stride + j] =
              __fmul_rn(__fmul_rn(rows[(size_t)r * N + q * stride + j], si[q]), sj);
        }
      }
    }
  }
}

// the same over a warp's nq <= RR rows held in registers, kreg[q][k] the
// entry of row r + q K5_WARPS in column wl + 32 k
template <bool FIRST, int RR, int JR>
__device__ __forceinline__ void k5_reg_sweep(const float (&kreg)[RR][JR], int nq, int r, int r0,
                                             const float* __restrict__ s_all, float* own,
                                             int N, int wl) {
  float si[K5_GROUP], mx[K5_GROUP] = {0.0f, 0.0f, 0.0f, 0.0f};
  k5_row_s<FIRST>(si, nq, r0 + r, s_all);
#pragma unroll
  for (int k = 0; k < JR; ++k) {
    const int j = wl + 32 * k;
    if (j < N) {
      const float sj = FIRST ? 1.0f : s_all[j];
#pragma unroll
      for (int q = 0; q < RR; ++q) {
        if (q < nq) {
          const float v = kreg[q][k];
          mx[q] = nmaxf(mx[q], fabsf(FIRST ? v : __fmul_rn(__fmul_rn(v, si[q]), sj)));
        }
      }
    }
  }
  k5_finish(mx, si, nq, own, r, wl);
}

template <int RR, int JR>
__device__ __forceinline__ void k5_reg_write(const float (&kreg)[RR][JR], int nq, int r, int r0,
                                             const float* __restrict__ s_all,
                                             float* __restrict__ out, int N, int wl) {
  float si[K5_GROUP];
  k5_row_s<false>(si, nq, r0 + r, s_all);
#pragma unroll
  for (int k = 0; k < JR; ++k) {
    const int j = wl + 32 * k;
    if (j < N) {
      const float sj = s_all[j];
#pragma unroll
      for (int q = 0; q < RR; ++q) {
        if (q < nq) {
          out[(size_t)(r + q * K5_WARPS) * N + j] = __fmul_rn(__fmul_rn(kreg[q][k], si[q]), sj);
        }
      }
    }
  }
}

// After a sweep: every CTA's s of its rows is in its buffer `own`; one
// cluster barrier, then this CTA gathers the lane's whole s into s_all
// (rank q holds rows q R ..). The buffer a sweep writes is not the one the
// sweep before wrote, so no rank overwrites what another may still gather.
__device__ __forceinline__ void k5_exchange(cg::cluster_group& cluster, float* s_all,
                                            float* own, int N, int R) {
  cluster.sync();
  for (int i = threadIdx.x; i < N; i += K5_THREADS) {
    const int q = i / R;
    s_all[i] = cluster.map_shared_rank(own, q)[i - q * R];
  }
  __syncthreads();
}

// RR: rows a warp holds in registers (0: none), of N <= 32 JR columns
template <int RR, int JR, int MINB>
__global__ void __launch_bounds__(K5_THREADS, MINB)
ruiz_cluster_kernel(const float* __restrict__ K, float* __restrict__ M, float* __restrict__ s,
                    int B, int N, int R, int res) {
  extern __shared__ float4 k5_dyn[];
  __shared__ uint64_t k5_mbar;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.dim_blocks().x;
  const int rank = (int)cluster.block_rank();
  const int clusters = (int)gridDim.x / C;
  const int R4 = k5_pad4(R);
  float* s_all = reinterpret_cast<float*>(k5_dyn);
  float* s_own = s_all + k5_pad4(N);              // [2][R4]
  float* rows = s_own + 2 * R4;                   // 16-byte aligned
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int r0 = rank * R;
  const int nrows = max(0, min(R, N - r0));
  const int nres = min(res, nrows);
  const int cnt = nres * N;                       // entries in shared memory
  const int rend = min(nrows, nres + K5_WARPS * RR);   // rows nres .. rend - 1 in registers
  const int rreg = nres + warp;                   // this warp's first one
  const int nreg = k5_group_rows(rreg, rend, RR);
  constexpr int U = RR ? K5_UNROLL_REG : K5_UNROLL;
  float kreg[RR > 0 ? RR : 1][JR];
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(k5_saddr(&k5_mbar)), "r"(1)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  unsigned phase = 0;
  int par = 0;

  for (int lane = (int)blockIdx.x / C; lane < B; lane += clusters) {
    const float* __restrict__ Kr = K + ((size_t)lane * N + r0) * N;   // the CTA's rows
    float* __restrict__ Mr = M + ((size_t)lane * N + r0) * N;
    const int shift = k3_shift(Kr);
    const float* res_rows = rows + shift;
    if (cnt > 0 && tid == 0) {
      // the previous lane's reads of rows are done (the barrier ending it)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      k5_bulk_load(rows, Kr - shift, 16u * (unsigned)((shift + cnt + 3) >> 2), &k5_mbar);
    }
#pragma unroll
    for (int q = 0; q < RR; ++q) {
#pragma unroll
      for (int k = 0; k < JR; ++k) {
        const int j = wl + 32 * k;
        kreg[q][k] = (q < nreg && j < N) ? Kr[(size_t)(rreg + q * K5_WARPS) * N + j] : 0.0f;
      }
    }
    if (cnt > 0) {
      k5_wait(&k5_mbar, phase);
      phase ^= 1;
    }

    for (int sweep = 0; sweep < K5_SWEEPS; ++sweep, par ^= 1) {
      float* own = s_own + par * R4;
      if (sweep == 0) {
        k5_sweep<true, U>(res_rows, 0, nres, r0, s_all, own, N, warp, wl);
        if (nreg > 0) k5_reg_sweep<true>(kreg, nreg, rreg, r0, s_all, own, N, wl);
        k5_sweep<true, U>(Kr, rend, nrows, r0, s_all, own, N, warp, wl);
      } else {
        k5_sweep<false, U>(res_rows, 0, nres, r0, s_all, own, N, warp, wl);
        if (nreg > 0) k5_reg_sweep<false>(kreg, nreg, rreg, r0, s_all, own, N, wl);
        k5_sweep<false, U>(Kr, rend, nrows, r0, s_all, own, N, warp, wl);
      }
      k5_exchange(cluster, s_all, own, N, R);
    }

    k5_write<U>(res_rows, Mr, 0, nres, r0, s_all, N, warp, wl);
    if (nreg > 0) k5_reg_write(kreg, nreg, rreg, r0, s_all, Mr, N, wl);
    k5_write<U>(Kr, Mr, rend, nrows, r0, s_all, N, warp, wl);
    for (int r = tid; r < nrows; r += K5_THREADS) s[(size_t)lane * N + r0 + r] = s_all[r0 + r];
    __syncthreads();   // rows and s_all are free for the next lane
  }
  cluster.sync();   // no CTA leaves while another may still gather from its shared memory
}

// the attributes a launch needs: its dynamic shared memory and, for C > 8,
// a non-portable cluster size
template <int RR, int JR, int MINB>
cudaError_t k5_attributes(int smem) {
  const void* fn = (const void*)ruiz_cluster_kernel<RR, JR, MINB>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// clusters of C CTAs of K5_THREADS
cudaLaunchConfig_t k5_config(int clusters, int C, int smem, void* stream,
                             cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = k2c_config(clusters, C, smem, stream, attr);
  cfg.blockDim = dim3(K5_THREADS);
  return cfg;
}

template <int RR, int JR, int MINB>
int k5_occupancy(int C, int smem, int* max_clusters) {
  cudaError_t err = k5_attributes<RR, JR, MINB>(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = k5_config(1, C, smem, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(
      max_clusters, (const void*)ruiz_cluster_kernel<RR, JR, MINB>, &cfg);
}

template <int RR, int JR, int MINB>
int k5_launch(const void* K, void* M, void* s, int B, int N, int C, int R, int res,
              int clusters, int smem, void* stream) {
  cudaError_t err = k5_attributes<RR, JR, MINB>(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = k5_config(clusters, C, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, ruiz_cluster_kernel<RR, JR, MINB>, (const float*)K, (float*)M,
                           (float*)s, B, N, R, res);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K6 semantics, both variants: LAPACK geqrf on each lane's row-major N x N
// f32 matrix M, written to qr: R on and above the diagonal, reflector k's
// entries below it (v_k has an implied 1 at row k), tau (N,);
// H_k = I - tau_k v_k v_k^T, Q = H_0 .. H_{N-1}, each reflector by larfg's
// rule without its rescaling loop: beta = -sign(alpha) sqrt(alpha^2 + |x|^2),
// tau = (beta - alpha) / beta, v = x / (alpha - beta), and tau = 0 (H = I)
// where the column below the diagonal is zero. No Q is formed: the JAX
// package multiplies by Q^T, K7 applies the reflectors. A zero column leaves
// a zero on R's diagonal and a NaN entry NaNs, so the solve is non-finite
// and the delta ladder retries, as with LAPACK in the JAX package.
// ---------------------------------------------------------------------------

// larfg on (alpha, |x|^2): returns beta, sets tau and the scale 1/(alpha - beta)
__device__ __forceinline__ float larfg(float alpha, float xnorm2, float& tau, float& scale) {
  if (xnorm2 == 0.0f) {   // H = I (a NaN norm takes the other branch)
    tau = 0.0f;
    scale = 0.0f;
    return alpha;
  }
  const float beta = -copysignf(sqrtf(fmaf(alpha, alpha, xnorm2)), alpha);
  tau = (beta - alpha) / beta;
  scale = 1.0f / (alpha - beta);
  return beta;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL_MASK, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// K6, cluster variant: replaces jnp.linalg.qr at
// awebox_tpu/parallel/batch.py:382 wherever a lane fits a cluster's shared
// memory (the slice's N = 543 included).
//
// What bounds it: operations (4/3 N^3 f32 per lane), but like the LU factor
// it is held by its dependent chain: N reflectors, each a norm over a column
// before the next can form. The layout is K2's: a lane is one cluster of
// C <= 8 CTAs whose shared memories hold it (whole columns, column-major,
// panels of NB = 16 dealt block-cyclically), read from HBM once and written
// once. Per panel p (the owner o(p) = p % C):
//   1. panel factor, on o(p): a warp per column, the column in the warp's
//      registers (K6_ROWS entries a lane); warp k forms reflector k (norm by
//      shuffles, larfg), writes it to the panel and, after one block barrier,
//      the warps of the later columns apply it to theirs. Then the panel's
//      Gram matrix G = V^T V (warp k: v_k from its registers against the
//      stored v_j, j < k) and its 16 x 16 upper-triangular T by larft's
//      forward recurrence (T[k][k] = tau_k, T[0:k, k] = -tau_k T[0:k, 0:k]
//      G[0:k, k]; lane i of warp 0 keeps row i in registers) are published
//      in s_T, the taus on its diagonal;
//   2. every CTA with trailing columns copies the panel's reflectors from
//      o(p)'s shared memory (DSMEM), masked (an explicit 1 on the diagonal,
//      zeros above it and past the panel's w columns), as rows of 16 in Vs,
//      and T into s_Tl;
//   3. compact-WY trailing update (k6_wy): a warp takes one column into
//      registers; W = V^T a is one pass over the rows with 16 accumulators,
//      whose 16 sums reduce side by side (a reduce-scatter of 16
//      shuffles leaves W[i] on lanes 2i, 2i+1), then Y = T^T W (lane 2k
//      forms Y[k] from the 16 W[i] by shuffles) and a -= V Y in a second
//      pass. No dependent reduction per reflector. Vs holds rows of 16, so a
//      lane reads its row's 16 reflector entries as 4 float4 at offsets
//      fixed at compile time (4 address registers where 16 columns would
//      need 16), swizzled so that a warp's rows hit every bank group.
// Look-ahead, on a split cluster barrier (barrier.cluster.arrive.release /
// wait.acquire), one phase per panel: phase p + 1 completes when every CTA
// has copied panel p and o(p + 1) has published panel p + 1. A CTA waits for
// phase p, copies panel p and arrives; o(p + 1) first applies panel p to its
// 16 columns of panel p + 1 (in registers, which its panel factor then
// takes), factors panel p + 1, forms and publishes its T, and only then
// arrives. The other trailing columns of every CTA are updated after the
// arrive, so they run in the shadow of the next panel's factor: the chain per
// panel is one copy, one 16-column update and one panel factor.
// Hazards. Every CTA arrives once and waits once a panel, in order; the last
// wait and a cluster.sync() precede the store, so no CTA leaves while another
// may read its shared memory. Readers take V from the owner's columns, which
// no one writes after their panel, and T from the owner's s_T before they
// arrive; an owner rewrites s_T (taus, G, then T) only for its next panel,
// p + C, after waiting for phase p + C - 1 >= p + 1, which every reader of
// panel p has arrived at. So s_T needs no second buffer (C >= 2 wherever
// there are two panels). Vs and s_Tl are the CTA's own, rewritten after a
// block barrier.
// Registers: __launch_bounds__(512, 1) allows 128 a thread. A warp updates
// one column at a time (K6_ROWS = 20 entries and its 16 sums): ptxas -v reads
// 128 registers and 24 bytes of spill stores for one column and for two side
// by side alike (16 with the update cut out), and 1.3 KB for three; one runs
// 0.6% faster than two (the update is hidden behind the chain).
// IEEE f32 FMA on the CUDA cores; sums in a fixed order, nothing atomic.
// What bounds it (H100, N = 543, phase cuts of
// awebox_tpu_torch/probes/qr_phases.py; PERF.md): the chain of panel factors,
// ~0.95 us a column (a norm and a dot, each a 5-level shuffle reduction,
// larfg and a block barrier), half of the 1.02 ms at B = 1; the other half is
// the copy, the 16-column update, G, T and the cluster phases between panels.
// A barrier per column beats per-column flags (release/acquire, no block
// barrier), which ran 4% slower. The H100 runs 15 clusters of 8 (or of 7) at
// once, so B = 16 takes two waves.
// ---------------------------------------------------------------------------
constexpr int K6_THREADS = 512;
constexpr int K6_WARPS = K6_THREADS / 32;
constexpr int K6_NB = 16;
constexpr int K6_ROWS = 20;           // column entries a lane holds: N <= 640
constexpr int K6_ROWSTEP = K6_THREADS / K6_NB;
static_assert(K6_WARPS == K6_NB, "a warp per panel column");

__device__ __forceinline__ void k6_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void k6_cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A warp holds a column as a[t] = row wl + 32 t, t = T0 .. K6_ROWS - 1: T0 is
// compiled in (the panels' first row p0 rounded down to 128 rows, see
// k6_panels), so every loop over t unrolls without a branch; rows outside
// p0..N-1 hold zeros and meet zeros of v.
//
// Reflector k (global column and row gk) applied to the column a warp holds:
// a -= tau v (v^T a), v read once from the panel column V (implied 1 at gk,
// zeros above). The panel factor's step.
template <int T0>
__device__ __forceinline__ void k6_apply(float (&a)[K6_ROWS], const float* __restrict__ V,
                                         float tau, int gk, int N, int wl) {
  float v[K6_ROWS];
  float dot[2] = {0.0f, 0.0f};
#pragma unroll
  for (int t = T0; t < K6_ROWS; ++t) {
    const int r = wl + 32 * t;
    v[t] = (r > gk && r < N) ? V[r] : (r == gk ? 1.0f : 0.0f);
    dot[t & 1] = fmaf(v[t], a[t], dot[t & 1]);
  }
  dot[0] += dot[1];
  for (int off = 16; off > 0; off >>= 1) dot[0] += __shfl_xor_sync(FULL_MASK, dot[0], off);
  const float f = tau * dot[0];
#pragma unroll
  for (int t = T0; t < K6_ROWS; ++t) a[t] = fmaf(-f, v[t], a[t]);
}

// a warp's column, rows p0..N-1 (padded rows of the column hold zeros)
template <int T0>
__device__ __forceinline__ void k6_load(float (&a)[K6_ROWS], const float* __restrict__ col,
                                        int p0, int N, int wl) {
#pragma unroll
  for (int t = T0; t < K6_ROWS; ++t) {
    const int r = wl + 32 * t;
    a[t] = (r >= p0 && r < N) ? col[r] : 0.0f;
  }
}

template <int T0>
__device__ __forceinline__ void k6_store(const float (&a)[K6_ROWS], float* __restrict__ col,
                                         int p0, int N, int wl) {
#pragma unroll
  for (int t = T0; t < K6_ROWS; ++t) {
    const int r = wl + 32 * t;
    if (r >= p0 && r < N) col[r] = a[t];
  }
}

// One step of k6_reduce_scatter: a lane keeps H of its 2H sums (the upper
// half where bit 2H of its lane is set) and adds its partner's halves.
template <int H>
__device__ __forceinline__ void k6_halve(float (&x)[K6_NB], int wl) {
  const bool hi = (wl & (2 * H)) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = hi ? x[i] : x[i + H];
    const float keep = hi ? x[i + H] : x[i];
    x[i] = keep + __shfl_xor_sync(FULL_MASK, send, 2 * H);
  }
}

// 16 partial sums a lane -> their warp sums, lane l keeping sum (l >> 1):
// each step hands half of what a lane holds to its partner (16 shuffles in
// all where a butterfly over each sum would take 80); the order is fixed.
__device__ __forceinline__ float k6_reduce_scatter(float (&x)[K6_NB], int wl) {
  k6_halve<8>(x, wl);
  k6_halve<4>(x, wl);
  k6_halve<2>(x, wl);
  k6_halve<1>(x, wl);
  return x[0] + __shfl_xor_sync(FULL_MASK, x[0], 1);
}

// Vs holds row r of the panel's masked reflectors as 4 float4, chunk q at
// position q ^ ((r >> 1) & 3): lanes at 8 consecutive rows then read a chunk
// from 8 different bank groups. Row r = wl + 32 t keeps (r >> 1) & 3 of wl.
__device__ __forceinline__ int k6_vs_chunk(int r, int q) { return q ^ ((r >> 1) & 3); }

// The panel's reflectors (Vs, masked, rows of 16) and T (Tl, row-major)
// applied to the column a warp holds, as one block reflector:
// a -= V (T^T (V^T a)).
template <int T0>
__device__ __forceinline__ void k6_wy(float (&a)[K6_ROWS], const float* __restrict__ Vs,
                                      const float* __restrict__ Tl, int N, int wl) {
  float x[K6_NB];
#pragma unroll
  for (int k = 0; k < K6_NB; ++k) x[k] = 0.0f;
  const float4* V4 = reinterpret_cast<const float4*>(Vs);
  const int sw = (wl >> 1) & 3;
  // W = V^T a: 16 sums a column in one pass over the rows
#pragma unroll
  for (int t = T0; t < K6_ROWS; ++t) {
    const int r = wl + 32 * t;
    if (r < N) {
#pragma unroll
      for (int c = 0; c < K6_NB / 4; ++c) {
        const float4 v = V4[4 * r + (c ^ sw)];
        x[4 * c] = fmaf(v.x, a[t], x[4 * c]);
        x[4 * c + 1] = fmaf(v.y, a[t], x[4 * c + 1]);
        x[4 * c + 2] = fmaf(v.z, a[t], x[4 * c + 2]);
        x[4 * c + 3] = fmaf(v.w, a[t], x[4 * c + 3]);
      }
    }
  }
  // lanes 2i, 2i + 1 hold W[i]; lane l forms Y[l >> 1] = sum_{i <= l >> 1} T[i][l >> 1] W[i]
  const float wi = k6_reduce_scatter(x, wl);
  float y = 0.0f;
  const int kk = wl >> 1;
#pragma unroll
  for (int i = 0; i < K6_NB; ++i) {
    const float tik = Tl[i * K6_NB + kk];      // zero below the diagonal
    y = fmaf(tik, __shfl_sync(FULL_MASK, wi, 2 * i), y);
  }
#pragma unroll
  for (int k = 0; k < K6_NB; ++k) x[k] = __shfl_sync(FULL_MASK, y, 2 * k);
  // a -= V Y
#pragma unroll
  for (int t = T0; t < K6_ROWS; ++t) {
    const int r = wl + 32 * t;
    if (r < N) {
#pragma unroll
      for (int c = 0; c < K6_NB / 4; ++c) {
        const float4 v = V4[4 * r + (c ^ sw)];
        a[t] = fmaf(-x[4 * c], v.x, a[t]);
        a[t] = fmaf(-x[4 * c + 1], v.y, a[t]);
        a[t] = fmaf(-x[4 * c + 2], v.z, a[t]);
        a[t] = fmaf(-x[4 * c + 3], v.w, a[t]);
      }
    }
  }
}

// The current panel applied to ncols local columns A, A + ld, .. (rows
// p0..N-1): warp u takes columns u, u + 16, .., each read into registers
// once and written back once.
template <int T0>
__device__ __forceinline__ void k6_update(float* __restrict__ A, int ld, int ncols,
                                          const float* __restrict__ Vs,
                                          const float* __restrict__ Tl, int p0, int N) {
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  for (int c = warp; c < ncols; c += K6_WARPS) {
    float a[K6_ROWS];
    k6_load<T0>(a, A + (size_t)c * ld, p0, N, wl);
    k6_wy<T0>(a, Vs, Tl, N, wl);
    k6_store<T0>(a, A + (size_t)c * ld, p0, N, wl);
  }
}

// Householder QR of a panel: local columns P + k * ld (k < w), global columns
// and diagonal rows g0 + k, a warp per column held in registers from row lo
// (<= g0) on. With Vs, each column first takes the previous panel's block
// reflector (Vs, Tl) in registers: the look-ahead. Then G and T into Tp
// (published; the taus on its diagonal, also written to tl).
template <int T0>
__device__ __forceinline__ void k6_factor(float* __restrict__ P, int ld, int lo, int g0, int w,
                                          int N, const float* __restrict__ Vs,
                                          const float* __restrict__ Tl, float* __restrict__ Tp,
                                          float* __restrict__ tl) {
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  float a[K6_ROWS];
  if (warp < w) {                       // warps past w idle
    k6_load<T0>(a, P + (size_t)warp * ld, lo, N, wl);
    if (Vs != nullptr) k6_wy<T0>(a, Vs, Tl, N, wl);
  }
  for (int k = 0; k < w; ++k) {
    const int gk = g0 + k;
    if (warp == k) {
      float mine = 0.0f, x2[2] = {0.0f, 0.0f};
#pragma unroll
      for (int t = T0; t < K6_ROWS; ++t) {
        const int r = wl + 32 * t;
        if (r == gk) mine = a[t];
        const float below = r > gk ? a[t] : 0.0f;
        x2[t & 1] = fmaf(below, below, x2[t & 1]);
      }
      const float alpha = __shfl_sync(FULL_MASK, mine, gk & 31);
      float tau, scale;
      const float beta = larfg(alpha, warp_sum(x2[0] + x2[1]), tau, scale);
#pragma unroll
      for (int t = T0; t < K6_ROWS; ++t) {
        const int r = wl + 32 * t;
        a[t] = r == gk ? beta : (r > gk ? a[t] * scale : a[t]);
      }
      k6_store<T0>(a, P + (size_t)k * ld, lo, N, wl);
      if (wl == 0) {
        Tp[k * K6_NB + k] = tau;
        tl[gk] = tau;
      }
    }
    __syncthreads();                    // reflector k is in the panel
    if (warp > k && warp < w) k6_apply<T0>(a, P + (size_t)k * ld, Tp[k * K6_NB + k], gk, N, wl);
  }
  // G[j][k] = v_j^T v_k (j < k) over rows gk.. (v_k: an implied 1 at gk, from
  // this warp's registers; v_j: the stored panel), into Tp's upper triangle
  if (warp < w) {
    const int gk = g0 + warp;
    float g[K6_NB];
#pragma unroll
    for (int t = T0; t < K6_ROWS; ++t) {   // a becomes v_k
      const int r = wl + 32 * t;
      a[t] = r > gk ? a[t] : (r == gk ? 1.0f : 0.0f);
    }
#pragma unroll
    for (int j = 0; j < K6_NB; ++j) {
      g[j] = 0.0f;
      if (j < warp) {                   // uniform: warp k reads k stored columns
#pragma unroll
        for (int t = T0; t < K6_ROWS; ++t) {
          const int r = wl + 32 * t;
          if (r < N) g[j] = fmaf(P[(size_t)j * ld + r], a[t], g[j]);
        }
      }
    }
    const float gj = k6_reduce_scatter(g, wl);   // G[wl >> 1][warp]
    if ((wl & 1) == 0 && (wl >> 1) < warp) Tp[(wl >> 1) * K6_NB + warp] = gj;
  }
  __syncthreads();
  if (warp == 0 && wl < K6_NB) {        // lane i: row i of T, from G and the taus in Tp
    const int i = wl;
    float tr[K6_NB];
#pragma unroll
    for (int k = 0; k < K6_NB; ++k) {
      float s[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < k; ++j) {
        if (j >= i) s[j & 1] = fmaf(tr[j], Tp[j * K6_NB + k], s[j & 1]);
      }
      const float tk = Tp[k * K6_NB + k];
      tr[k] = k >= w ? 0.0f : (i < k ? -tk * (s[0] + s[1]) : (i == k ? tk : 0.0f));
    }
    __syncwarp(0xffffu);                // every lane has read G before T replaces it
#pragma unroll
    for (int k = 0; k < K6_NB; ++k) Tp[i * K6_NB + k] = tr[k];
  }
  __syncthreads();
}

// What a CTA of the cluster kernel knows of its lane
struct K6Lane {
  float* As;        // [cols][ld] this CTA's columns
  float* Vs;        // [ld][NB] the current panel's masked reflectors, rows of 16
  float* Tp;        // [NB][NB] T of the panel this CTA factored last (published)
  float* Tl;        // [NB][NB] T of the current panel, local copy
  float* tl;        // (N,) the lane's taus
  int N, ld, C, rank, ncl, n_panels;
};

// Panels p_begin .. p_end - 1, whose first rows lie in 32 T0 .. 32 T0 + 127.
// On entry the CTA has arrived at the phase of panel p_begin.
template <int T0>
__device__ __forceinline__ void k6_panels(cg::cluster_group& cluster, const K6Lane& L,
                                          int p_begin, int p_end) {
  const int tid = threadIdx.x;
  const int N = L.N, ld = L.ld, C = L.C, rank = L.rank;
  for (int p = p_begin; p < p_end; ++p) {
    const int owner = p % C;
    const int lpo = p / C;               // the panel's local index on its owner
    const int p0 = p * K6_NB;
    const int w = min(K6_NB, N - p0);
    // trailing columns: the local panels after panel p
    const int lp_start = (p < rank) ? 0 : (p - rank) / C + 1;
    const int c0 = lp_start * K6_NB;
    const int ntc = L.ncl - c0;
    // this CTA owns panel p + 1: then it is local panel lp_start
    const bool next = p + 1 < L.n_panels && rank == (p + 1) % C;
    k6_cluster_wait();                  // panel p is published
    if (ntc > 0) {                      // uniform over the CTA
      // rows 32 T0..N-1 of the panel, a thread per row, masked; and T
      const float* rP = cluster.map_shared_rank(L.As, owner) + (size_t)lpo * K6_NB * ld;
      const float* rT = cluster.map_shared_rank(L.Tp, owner);
      for (int r = 32 * T0 + tid; r < N; r += K6_THREADS) {
        float v[K6_NB];
#pragma unroll
        for (int k = 0; k < K6_NB; ++k) {
          const int gk = p0 + k;
          v[k] = (k < w && r > gk) ? rP[(size_t)k * ld + r] : ((k < w && r == gk) ? 1.0f : 0.0f);
        }
        float4* d4 = reinterpret_cast<float4*>(L.Vs) + 4 * r;
#pragma unroll
        for (int c = 0; c < K6_NB / 4; ++c) {
          d4[k6_vs_chunk(r, c)] = make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
        }
      }
      if (tid < K6_NB * K6_NB) L.Tl[tid] = rT[tid];
      __syncthreads();
    }
    int done = 0;                       // local trailing columns updated before the arrive
    if (next) {
      const int w1 = min(K6_NB, N - p0 - K6_NB);
      k6_factor<T0>(L.As + (size_t)c0 * ld, ld, p0, p0 + K6_NB, w1, N, L.Vs, L.Tl, L.Tp, L.tl);
      done = K6_NB;
    }
    k6_cluster_arrive();                // panel p is copied, panel p + 1 published if ours
    if (ntc > done) {
      k6_update<T0>(L.As + (size_t)(c0 + done) * ld, ld, ntc - done, L.Vs, L.Tl, p0, N);
    }
    __syncthreads();                    // Vs and Tl are free for the next panel
  }
}

__global__ void __launch_bounds__(K6_THREADS, 1)
qr_factor_cluster_kernel(const float* __restrict__ M, float* __restrict__ qr,
                         float* __restrict__ tau, int N, int ld, int cols) {
  extern __shared__ float4 k6_dyn[];
  __shared__ float s_T[K6_NB * K6_NB];
  __shared__ float s_Tl[K6_NB * K6_NB];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.dim_blocks().x;
  const int rank = (int)cluster.block_rank();
  const int lane = blockIdx.x / C;
  float* As = reinterpret_cast<float*>(k6_dyn);
  const float* src = M + (size_t)lane * N * N;
  float* dst = qr + (size_t)lane * N * N;
  const int tid = threadIdx.x;
  const int n_panels = (N + K6_NB - 1) / K6_NB;
  const int n_local = (n_panels - rank + C - 1) / C;
  const int lc = tid % K6_NB, li = tid / K6_NB;   // the load's column and first row
  // the last local panel is padded with zero columns
  const K6Lane L = {As, As + (size_t)cols * ld, s_T, s_Tl, tau + (size_t)lane * N,
                    N, ld, C, rank, n_local * K6_NB, n_panels};

  // load: column lp*NB + lc holds global column j; rows N..ld-1 are zero
  for (int lp = 0; lp < n_local; ++lp) {
    const int j = (lp * C + rank) * K6_NB + lc;
    float* col = As + (size_t)(lp * K6_NB + lc) * ld;
    for (int i = li; i < ld; i += K6_ROWSTEP) {
      if (j < N && i < N) {
        cp_async4(col + i, src + (size_t)i * N + j);
      } else {
        col[i] = 0.0f;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // panel 0 (rank 0's local panel 0) before the first phase
  if (rank == 0) k6_factor<0>(As, ld, 0, 0, min(K6_NB, N), N, nullptr, nullptr, s_T, L.tl);
  k6_cluster_arrive();
  // eight panels of 16 columns start within the same 128 rows: T0 = 0, 4, ..
  k6_panels<0>(cluster, L, 0, min(8, n_panels));
  k6_panels<4>(cluster, L, 8, min(16, n_panels));
  k6_panels<8>(cluster, L, 16, min(24, n_panels));
  k6_panels<12>(cluster, L, 24, min(32, n_panels));
  k6_panels<16>(cluster, L, 32, n_panels);
  k6_cluster_wait();
  cluster.sync();   // no CTA leaves while another may still read its shared memory

  for (int lp = 0; lp < n_local; ++lp) {
    const int j = (lp * C + rank) * K6_NB + lc;
    if (j >= N) continue;
    const float* col = As + (size_t)(lp * K6_NB + lc) * ld;
    for (int i = li; i < N; i += K6_ROWSTEP) dst[(size_t)i * N + j] = col[i];
  }
}

// the cluster variant's launch configuration: B clusters of C CTAs
cudaLaunchConfig_t k6_config(int B, int C, int smem, void* stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = k2c_config(B, C, smem, stream, attr);
  cfg.blockDim = dim3(K6_THREADS);
  return cfg;
}

// ---------------------------------------------------------------------------
// K6, blocked variant: replaces jnp.linalg.qr at awebox_tpu/parallel/batch.py:382
// for lanes that no cluster's shared memory holds (N = 1055 of the n_k = 8
// system). LAPACK geqrf's blocked Householder QR (geqr2 on a panel, larft,
// larfb) on the lane in global memory: M is copied to qr and factored there,
// in panels of KB_NB = 32 columns, three launches a panel:
//   1. qr_panel_kernel, one CTA of 32 warps per lane: the panel's rows
//      k0..N-1 in shared memory (K2's blocked layout), a warp per column:
//      warp k forms reflector k (larfg on a norm by shuffles), one block
//      barrier, and every later warp applies it to its own column (a dot by
//      shuffles, then the update), so one barrier a column; then the
//      panel's Gram matrix G = V^T V (a warp per column) and its T factor
//      (larft's forward recurrence, T[0:k, k] = -tau_k T[0:k, 0:k]
//      G[0:k, k], by warp 0), written beside the taus;
//   2. qr_w_kernel, grid (strips of KB_NB trailing columns, B): W = V^T A22,
//      the reflectors staged in shared memory a chunk of rows at a time and
//      read as 16-byte broadcasts, each thread summing one column over a
//      row group, the 8 groups' partial sums added in their order;
//   3. qr_update_kernel, grid (KB_TR x KB_TC tiles of rows k0.. and the
//      trailing columns, B): Y = T^T W for the tile's columns, then
//      A22 -= V Y by K2's blocked rank update.
// What bounds it: 4/3 N^3 f32 operations, 1.57 GFLOP a lane at N = 1055 (47
// us on the whole card at B = 2); a one-block-per-lane kernel pulls ~N^3
// 4-byte accesses through L2 with one SM per lane. Here,
// as in K2's blocked variant, the updates spread over the card and the
// critical path is the chain of panel factors, G and T, on one SM per lane;
// launches rather than a persistent kernel for the reasons given there.
// IEEE f32 FMA on the CUDA cores; sums in a fixed order, nothing atomic.
// ---------------------------------------------------------------------------
constexpr int KB_WROWS = 64;                  // rows of V and A22 a W pass stages at a time

__global__ void __launch_bounds__(KB_THREADS, 1)
qr_panel_kernel(float* __restrict__ qr, float* __restrict__ tau, float* __restrict__ Tg, int N,
                int k0, int lds) {
  extern __shared__ float kb_dyn[];
  float* P = kb_dyn;                          // [KB_NB][lds] the panel's rows k0..N-1
  __shared__ float s_tau[KB_NB];
  __shared__ float G[KB_NB][KB_NB + 1];       // G[j][k] = v_j^T v_k, j < k
  __shared__ float T[KB_NB][KB_NB + 1];       // upper triangular, zeros elsewhere
  float* a = qr + (size_t)blockIdx.x * N * N;
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int w = min(KB_NB, N - k0), rows = N - k0;
  kb_load_panel<float, KB_NB, KB_THREADS>(P, a, N, k0, w, lds);
  for (int e = tid; e < KB_NB * (KB_NB + 1); e += KB_THREADS) (&T[0][0])[e] = 0.0f;
  __syncthreads();
  float* col = P + warp * lds;                // this warp's column
  for (int k = 0; k < w; ++k) {
    if (warp == k) {
      __syncwarp();                           // the column's last update is in
      const float alpha = col[k];
      float x2[2] = {0.0f, 0.0f};
      for (int r = k + 1 + wl, t = 0; r < rows; r += 32, t ^= 1) x2[t] = fmaf(col[r], col[r], x2[t]);
      float tk, scale;
      const float beta = larfg(alpha, warp_sum(x2[0] + x2[1]), tk, scale);
      for (int r = k + 1 + wl; r < rows; r += 32) col[r] *= scale;
      if (wl == 0) {
        col[k] = beta;
        s_tau[k] = tk;
      }
    }
    __syncthreads();                          // reflector k is in the panel
    const float tk = s_tau[k];
    if (warp > k && warp < w && tk != 0.0f) { // H_k = I where tau_k = 0, as LAPACK's larf
      const float* v = P + k * lds;           // an implied 1 at row k
      float dot = 0.0f;
      for (int r = k + wl; r < rows; r += 32) dot = fmaf(r == k ? 1.0f : v[r], col[r], dot);
      const float f = tk * warp_sum(dot);
      for (int r = k + wl; r < rows; r += 32) col[r] = fmaf(-f, r == k ? 1.0f : v[r], col[r]);
    }
  }
  __syncthreads();
  // G[j][k] for j < k over rows k.. (v_k is zero above row k, 1 on it)
  if (warp < w) {
    float g[KB_NB];
#pragma unroll
    for (int j = 0; j < KB_NB; ++j) g[j] = 0.0f;
    for (int r = warp + wl; r < rows; r += 32) {
      const float vk = r == warp ? 1.0f : col[r];
#pragma unroll
      for (int j = 0; j < KB_NB; ++j) {
        if (j < warp) g[j] = fmaf(P[j * lds + r], vk, g[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < KB_NB; ++j) {
      if (j < warp) {                         // uniform over the warp
        const float s = warp_sum(g[j]);
        if (wl == 0) G[j][warp] = s;
      }
    }
  }
  __syncthreads();
  if (warp == 0) {                            // lane i computes row i of T
    for (int k = 0; k < w; ++k) {
      float t = 0.0f;
#pragma unroll
      for (int j = 0; j < KB_NB; ++j) {       // unrolled, so the loads run ahead of the chain
        if (j >= wl && j < k) t = fmaf(T[wl][j], G[j][k], t);
      }
      if (wl < k) T[wl][k] = -s_tau[k] * t;
      if (wl == k) T[k][k] = s_tau[k];
      __syncwarp();
    }
  }
  __syncthreads();
  float* tl = tau + (size_t)blockIdx.x * N + k0;
  if (tid < w) tl[tid] = s_tau[tid];
  float* Tl = Tg + (size_t)blockIdx.x * KB_NB * KB_NB;
  for (int e = tid; e < KB_NB * KB_NB; e += KB_THREADS) Tl[e] = T[e / KB_NB][e % KB_NB];
  kb_store_panel<float, KB_NB, KB_THREADS>(P, a, N, k0, w, lds);
}

// entry (r, k0 + k) of V: the factor's below the diagonal, an implied 1 on
// it, zeros above and past the panel's w columns
__device__ __forceinline__ float kb_v(const float* __restrict__ a, int N, int k0, int w, int r,
                                      int k) {
  const int d = k0 + k;
  return (k < w && r > d) ? a[(size_t)r * N + d] : ((k < w && r == d) ? 1.0f : 0.0f);
}

// W[k][j] = v_k^T A22[:, j] for a strip of KB_NB trailing columns j, into
// Wg (lanes, KB_NB, N) at column j
__global__ void __launch_bounds__(KB_UTHREADS)
qr_w_kernel(const float* __restrict__ qr, float* __restrict__ Wg, int N, int k0) {
  __shared__ __align__(16) float Vs[KB_WROWS][KB_NB];
  __shared__ float part[KB_UTHREADS / 32][KB_NB][KB_NB + 1];   // the row groups' sums
  const float* a = qr + (size_t)blockIdx.y * N * N;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int w = min(KB_NB, N - k0);
  const int c0 = k0 + w + blockIdx.x * KB_NB, nc = min(KB_NB, N - c0);
  constexpr int GROUPS = KB_UTHREADS / 32, PER = KB_WROWS / GROUPS;
  float acc[KB_NB];
#pragma unroll
  for (int k = 0; k < KB_NB; ++k) acc[k] = 0.0f;
  for (int r0 = k0; r0 < N; r0 += KB_WROWS) {
    __syncthreads();                          // the last chunk is consumed
    for (int e = tid; e < KB_WROWS * KB_NB; e += KB_UTHREADS) {
      const int i = e / KB_NB, k = e % KB_NB;
      Vs[i][k] = r0 + i < N ? kb_v(a, N, k0, w, r0 + i, k) : 0.0f;
    }
    float x[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {           // this thread's rows r0 + ty + 8 i, all in flight
      const int r = r0 + ty + GROUPS * i;
      x[i] = (r < N && tx < nc) ? a[(size_t)r * N + c0 + tx] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const float4* vr = reinterpret_cast<const float4*>(Vs[ty + GROUPS * i]);
#pragma unroll
      for (int q = 0; q < KB_NB / 4; ++q) {
        const float4 v = vr[q];
        acc[4 * q] = fmaf(v.x, x[i], acc[4 * q]);
        acc[4 * q + 1] = fmaf(v.y, x[i], acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(v.z, x[i], acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(v.w, x[i], acc[4 * q + 3]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < KB_NB; ++k) part[ty][k][tx] = acc[k];
  __syncthreads();
  float* W = Wg + (size_t)blockIdx.y * KB_NB * N;
  for (int e = tid; e < KB_NB * KB_NB; e += KB_UTHREADS) {
    const int k = e / KB_NB, j = e % KB_NB;
    float s = 0.0f;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) s += part[g][k][j];
    if (k < w && j < nc) W[(size_t)k * N + c0 + j] = s;
  }
}

// A22 -= V (T^T W) on rows k0..N-1 and the trailing columns k0 + w .. N-1
__global__ void __launch_bounds__(KB_UTHREADS)
qr_update_kernel(float* __restrict__ qr, const float* __restrict__ Tg,
                 const float* __restrict__ Wg, int N, int k0) {
  __shared__ __align__(16) float Ls[KB_NB * KB_LDL];   // [k][i] V of the tile's rows
  __shared__ __align__(16) float Us[KB_NB * KB_TC];    // [k][j] Y = T^T W of its columns
  __shared__ float Ts[KB_NB][KB_NB + 1];
  __shared__ float Ws[KB_NB][KB_TC];
  float* a = qr + (size_t)blockIdx.y * N * N;
  const float* W = Wg + (size_t)blockIdx.y * KB_NB * N;
  const float* Tl = Tg + (size_t)blockIdx.y * KB_NB * KB_NB;
  const int tid = threadIdx.x;
  const int w = min(KB_NB, N - k0), t0 = k0 + w;
  const int tiles_c = (N - t0 + KB_TC - 1) / KB_TC;
  const int r0 = k0 + (blockIdx.x / tiles_c) * KB_TR, c0 = t0 + (blockIdx.x % tiles_c) * KB_TC;
  const int nr = min(KB_TR, N - r0), nc = min(KB_TC, N - c0);
  for (int e = tid; e < KB_NB * KB_TR; e += KB_UTHREADS) {   // a warp reads a row
    const int i = e / KB_NB, k = e % KB_NB;
    Ls[k * KB_LDL + i] = i < nr ? kb_v(a, N, k0, w, r0 + i, k) : 0.0f;
  }
  for (int e = tid; e < KB_NB * KB_NB; e += KB_UTHREADS) Ts[e / KB_NB][e % KB_NB] = Tl[e];
  for (int e = tid; e < KB_NB * KB_TC; e += KB_UTHREADS) {
    const int k = e / KB_TC, j = e % KB_TC;
    Ws[k][j] = (k < w && j < nc) ? W[(size_t)k * N + c0 + j] : 0.0f;
  }
  __syncthreads();
  for (int e = tid; e < KB_NB * KB_TC; e += KB_UTHREADS) {   // Y[k][j] = sum_{i<=k} T[i][k] W[i][j]
    const int k = e / KB_TC, j = e % KB_TC;
    float y = 0.0f;
    for (int i = 0; i <= k; ++i) y = fmaf(Ts[i][k], Ws[i][j], y);
    Us[e] = y;
  }
  __syncthreads();
  kb_rank_update<float, KB_NB>(a, N, r0, c0, nr, nc, Ls, Us);
}

// ---------------------------------------------------------------------------
// K7: x = R^-1 (Q^T v) from K6's factor (or LAPACK's: the same layout),
// replacing msolve at awebox_tpu/parallel/batch.py:344-346 (the JAX package
// forms Q and multiplies by Q^T; here the reflectors are applied, the same
// function with other roundings). One CTA of WARPS warps per lane.
//
// What bounds it: the dependent chain, as K3. Its bytes are the factor once
// (1.18 MB a lane at N = 543, 0.35 us of HBM time), but Q^T v is N
// reflectors one after the other, each a dot product over a strided column
// of the row-major factor, and R^-1 is N dependent rows. The design walks
// both in ceil(N/32) steps and reads every entry of the factor once:
//   - Q^T v, 32 reflectors (a panel) at a time. Warp w owns rows w,
//     w + WARPS, .. of every 32-row tile (a lane per reflector) and
//     accumulates over them, in order, both w0 = V^T y and the panel's Gram
//     matrix G = V^T V, a row's 32 entries read back as eight 16-byte
//     broadcasts (by shuffles the Gram matrix alone took the SM's whole
//     shuffle rate; an 8 x 4 block of G a lane, three 16-byte loads a row,
//     ran slower). The warps' partials are summed in warp order; the 32 dependent dot
//     products v_c^T (H_{c-1} .. H_0 y) then follow without touching the
//     factor: w_c = w0_c - sum_{j<c} G_cj t_j, t_c = tau_c w_c, a forward
//     substitution of 32 shuffle-and-FMA steps in warp 0. Then each warp
//     updates its own rows, y -= V t, a lane per row, and goes on to the
//     next panel without a barrier: the rows of y it reads there are its own.
//   - R x = y over column tiles from the last, one block barrier a step:
//     warp 0 applies the previous column tile to the rows of the next
//     diagonal tile (a look-ahead, as K3) and solves that tile in registers
//     (the diagonal by its reciprocal, as K3), while warps 1.. apply the
//     same column tile to the rows above, a 32-row tile a warp and a lane a
//     row. Every row's dot product over a column tile runs in k7_dot32's
//     order, and a row takes the column tiles from the last, so every sum is
//     that of a whole-block update.
//   - No load of the factor sits on that chain. In Q^T v each warp streams
//     its rows of every tile of every panel, in the order it uses them
//     (K7Walk), GR tiles at a time, through a slot of shared memory that is
//     refilled as soon as its rows are copied out, so each copy runs GR
//     tiles ahead, across the reduction, substitution and barriers between
//     panels. Rows are 4N bytes apart, so a TMA tensor map
//     (16-byte strides) does not apply: as in K3, a row segment is copied
//     as the K3_CHUNKS aligned 16-byte blocks that cover it, by
//     cp.async.cg, and read from its own offset. (One 1-D bulk copy a row,
//     by the TMA engine, was tried and ran slower: awebox_tpu_torch/probes/
//     qr_phases.py.) tau is read a panel ahead. In R x = y each warp
//     streams its whole tiles through a ring of K7_BACK_SLOTS slots in K3's
//     layout (k3_load, k3_row), laid over the buffers of Q^T v.
// In Q^T v a row leaves its slot realigned and masked (V's unit diagonal,
// zeros past N) into the warp's rows of sV, whence the Gram pass and the
// update read it as float4. R's diagonal is kept there too, and its
// reciprocals are taken between the two passes, off the chain of the
// diagonal solves. Sums run in a fixed order (a warp's rows in order, then
// the warps in order) whatever GR and the batch, so a lane's bits depend
// only on WARPS. Nothing is skipped for a zero or non-finite entry, so a
// singular or NaN factor reaches x and the delta ladder retries.
// ---------------------------------------------------------------------------
constexpr int K7_NB = 32;                  // reflectors per panel, tile width: a warp
constexpr int K7_LDV = 36;                 // floats per staged row: 16-byte rows whose float4
                                           // reads by 8 consecutive rows hit 8 bank groups
constexpr int K7_SROW = 4 * K3_CHUNKS;     // floats per row of a staging slot: its aligned blocks

// sum_k row[k] z[k] over a staged row and 32 values z, both 16-byte aligned
__device__ __forceinline__ float k7_dot32(const float* row, const float* z) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4* z4 = reinterpret_cast<const float4*>(z);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int q = 0; q < K7_NB / 4; ++q) {
    const float4 r = r4[q], zz = z4[q];
    acc[0] = fmaf(r.x, zz.x, acc[0]);
    acc[1] = fmaf(r.y, zz.y, acc[1]);
    acc[2] = fmaf(r.z, zz.z, acc[2]);
    acc[3] = fmaf(r.w, zz.w, acc[3]);
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// The tiles of Q^T v a warp uses, in order, in groups of at most GR
// consecutive row tiles of one panel: panel s takes row tiles s..T-1 of
// column tile s. Past the last: s == T.
template <int GR>
struct K7Walk {
  int s, i;
  // the group's first row tile ti, its column tile tj and its n tiles
  __device__ __forceinline__ void group(int T, int& ti, int& tj, int& n) const {
    ti = i;
    tj = s;
    n = min(GR, T - i);
  }
  __device__ __forceinline__ void advance(int T) {
    i += GR;
    if (i >= T) i = ++s;
  }
};

// A warp's staging slot for its rows of the groups K7Walk lists: row j of
// the group's tile h lands at (h RPW + j) K7_SROW, the copy one cp.async
// group. The slot is taken (the copy waited for), copied out and given
// back, and giving it back issues the next group's copy into it: GR tiles
// ahead of their use, across the Gram pass of the group just copied out
// and, at a panel's end, its reduction, substitution and barriers. (A ring
// of two or four slots of half or a quarter the tiles ran slower: the
// wait, the copies' issue and the walk cost as much per slot whatever its
// size.) Every row of the warp starts sh floats into its first block: rows
// 32 apart, and tiles 32 columns apart, are a multiple of 16 bytes apart,
// and WARPS is a multiple of 4. So what a lane copies and reads is fixed
// once: start() computes it. Blocks that hold no entry of a tile (rows past
// N, columns past the tile's last) are zero-filled.
template <int WARPS, int GR>
struct K7Ring {
  static constexpr int RPW = K7_NB / WARPS;          // the warp's rows of a tile
  static constexpr int ROWS = GR * RPW;              // rows of the slot
  static constexpr int BLOCKS = ROWS * K3_CHUNKS;    // its 16-byte blocks
  static constexpr int PER_LANE = (BLOCKS + 31) / 32;
  static constexpr int SLOT = ROWS * K7_SROW;        // its floats
  float* slot;
  const float* a;
  int N, T;
  K7Walk<GR> ahead;             // the group the next copy fetches
  // the lane's blocks: offsets from the group's first entry and into the
  // slot; the tile of the group that holds it (GR: none); bit 0: it holds
  // an entry of a tile of column tile T - 1, bit 1: of any other, bit 2:
  // its row is one of the last row tile's N - 32 (T - 1)
  int src[PER_LANE], dst[PER_LANE], tile[PER_LANE], in[PER_LANE];

  __device__ __forceinline__ void issue() {
    if (ahead.s < T) {
      int ti, tj, n;
      ahead.group(T, ti, tj, n);
      const float* g0 = a + (size_t)(ti * N + tj) * K7_NB;
      const int need = tj == T - 1 ? 1 : 2;
#pragma unroll
      for (int q = 0; q < PER_LANE; ++q) {
        if (tile[q] < n) {
          const int need_q = need | (ti + tile[q] == T - 1 ? 4 : 0);
          cp_async16_zfill(slot + dst[q], g0 + src[q], (in[q] & need_q) == need_q);
        }
      }
      ahead.advance(T);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  __device__ __forceinline__ void start(int warp, int wl, int sh) {
    const int last = N - (T - 1) * K7_NB;            // rows and columns of the last tiles
#pragma unroll
    for (int q = 0; q < PER_LANE; ++q) {
      const int b = 32 * q + wl, rr = b / K3_CHUNKS, c4 = 4 * (b - rr * K3_CHUNKS);
      const int row = warp + WARPS * (rr % RPW);     // in its tile
      src[q] = ((rr / RPW) * K7_NB + row) * N + c4 - sh;
      dst[q] = rr * K7_SROW + c4;
      tile[q] = b < BLOCKS ? rr / RPW : GR;
      in[q] = (c4 < sh + last ? 1 : 0) | (c4 < sh + K7_NB ? 2 : 0) | (row < last ? 4 : 0);
    }
    ahead = {0, 0};
    issue();
  }

  // the next group, landed: row j of its tile h from (h RPW + j) K7_SROW + sh on
  __device__ __forceinline__ const float* take() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
    return slot;
  }

  // after the lanes' last read of the slot; the __syncwarp also publishes
  // to the warp what they stored since take()
  __device__ __forceinline__ void give_back() {
    __syncwarp();
    issue();
  }
};

constexpr int K7_BACK_SLOTS = 2;          // ring slots a warp streams whole tiles through in R x = y

// sum_k row[k] z[k] as k7_dot32, the same FMAs in the same order, over a row
// at any 4-byte offset (read one float at a time) and 16-byte aligned z
__device__ __forceinline__ float k7_dot32_any(const float* row, const float* z) {
  const float4* z4 = reinterpret_cast<const float4*>(z);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int q = 0; q < K7_NB / 4; ++q) {
    const float4 zz = z4[q];
    acc[0] = fmaf(row[4 * q], zz.x, acc[0]);
    acc[1] = fmaf(row[4 * q + 1], zz.y, acc[1]);
    acc[2] = fmaf(row[4 * q + 2], zz.z, acc[2]);
    acc[3] = fmaf(row[4 * q + 3], zz.w, acc[3]);
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// A warp's ring of K7_BACK_SLOTS whole tiles (row tile i, column tile c)
// for R x = y, in K3's slot layout (k3_load, k3_row). Warp 0 takes the
// diagonal tiles from the last, each but the last after the tile (c - 1, c)
// above it: (T-1, T-1), (T-2, T-1), (T-2, T-2), .., (0, 1), (0, 0). Warp
// w >= 1 takes, for each column tile c from T-1 down to 2, the tiles i =
// w - 1, w - 1 + (WARPS - 1), .. < c - 1. c < 0: no tile left. A slot is
// taken and given back before the next is taken; giving it back issues the
// copy K7_BACK_SLOTS tiles ahead into it.
template <int WARPS>
struct K7BackRing {
  float* first;
  float* next;
  const float* a;
  int N, warp, c, i;
  K3Blocks blocks;

  __device__ __forceinline__ void settle() {      // warp >= 1
    while (c >= 2 && i >= c - 1) {
      --c;
      i = warp - 1;
    }
    if (c < 2) c = -1;
  }

  __device__ __forceinline__ void issue(float* slot) {
    if (c >= 0) {
      k3_load(slot, blocks, a, N, i, c);
      if (warp > 0) {
        i += WARPS - 1;
        settle();
      } else if (i == c) {
        --i;
        if (i < 0) c = -1;
      } else {
        c = i;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  __device__ __forceinline__ void start(int T, int wl) {
    blocks.init(N, wl);
    c = T - 1;
    i = warp == 0 ? T - 1 : warp - 1;
    if (warp > 0) settle();
    next = first;
#pragma unroll
    for (int k = 0; k < K7_BACK_SLOTS; ++k) issue(first + k * K3_TILE);
  }

  __device__ __forceinline__ float* take() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(K7_BACK_SLOTS - 1) : "memory");
    __syncwarp();
    float* slot = next;
    next = slot == first + (K7_BACK_SLOTS - 1) * K3_TILE ? first : slot + K3_TILE;
    return slot;
  }

  __device__ __forceinline__ void give_back(float* slot) {
    __syncwarp();
    issue(slot);
  }
};

template <int WARPS, int GR>
__global__ void __launch_bounds__(WARPS * 32, 1)
qr_solve_kernel(const float* __restrict__ qr, const float* __restrict__ tau,
                const float* __restrict__ v, float* __restrict__ x, int N) {
  constexpr int THREADS = WARPS * 32, RPW = K7_NB / WARPS;
  extern __shared__ float4 k7_dyn[];
  __shared__ float G_f[K7_NB][K7_NB + 1];               // the panel's Gram matrix
  __shared__ float w_s[K7_NB];
  __shared__ __align__(16) float t_s[K7_NB];
  const int T = (N + K7_NB - 1) / K7_NB, Np = T * K7_NB, last = N - (T - 1) * K7_NB;
  const int lane = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  // y [Np] and R's diagonal [Np]; then for Q^T v the partial Gram matrices
  // [WARPS][NB][LDV], the partial V^T y [WARPS][NB], the warps' staged rows
  // [Np][LDV] and their slots [WARPS][SLOT], and for R x = y, in the same
  // room, the warps' tile rings [WARPS][K7_BACK_SLOTS][K3_TILE]
  float* y = reinterpret_cast<float*>(k7_dyn);
  float* dinv_s = y + Np;                               // [Np] R's diagonal, then its reciprocals
  float* Gp = dinv_s + Np;
  float* wp = Gp + WARPS * K7_NB * K7_LDV;
  // the warp's staged rows, [Np / WARPS][LDV]: its i-th row of a panel,
  // row p0 + warp + WARPS i
  float* sV = wp + WARPS * K7_NB + (size_t)warp * (Np / WARPS) * K7_LDV;
  const float* a = qr + (size_t)lane * N * N;
  const int sh = k3_shift(a + (size_t)warp * N), rd = sh + wl;
  K7Ring<WARPS, GR> ring;
  ring.slot = wp + WARPS * K7_NB + (size_t)Np * K7_LDV + (size_t)warp * ring.SLOT;
  ring.a = a;
  ring.N = N;
  ring.T = T;
  ring.start(warp, wl, sh);
  for (int i = tid; i < Np; i += THREADS) y[i] = i < N ? v[(size_t)lane * N + i] : 0.0f;
  __syncthreads();

  // y <- Q^T y = H_{N-1} .. H_0 y, a panel of 32 reflectors at a time
  for (int p = 0; p < T; ++p) {
    const int p0 = p * K7_NB, col = p0 + wl;
    const bool col_in = col < N;
    const float tc = (warp == 0 && col_in) ? tau[(size_t)lane * N + col] : 0.0f;
    float g[K7_NB];                     // row col of G, the warp's share
#pragma unroll
    for (int j = 0; j < K7_NB; ++j) g[j] = 0.0f;
    float w0 = 0.0f;
    float* sw = sV;                     // the warp's rows of the group's tiles
    for (int ti = p; ti < T; ti += GR, sw += GR * RPW * K7_LDV) {
      const int n = min(GR, T - ti);
      const float* slot = ring.take();
      // the lane's entry of each row, V's: every load issued before the first
      // store (a store between them would wait for each load in turn)
      float vr[GR][RPW];
#pragma unroll
      for (int h = 0; h < GR; ++h) {
#pragma unroll
        for (int j = 0; j < RPW; ++j) {
          vr[h][j] = col_in ? slot[(h * RPW + j) * K7_SROW + rd] : 0.0f;
        }
      }
      if (ti == p) {    // the diagonal tile: V's unit diagonal, zeros above; R's diagonal kept
#pragma unroll
        for (int j = 0; j < RPW; ++j) {
          const int r = p0 + warp + WARPS * j;
          if (r == col) dinv_s[r] = vr[0][j];
          vr[0][j] = r > col ? vr[0][j] : (r == col ? 1.0f : 0.0f);
        }
      }
#pragma unroll
      for (int h = 0; h < GR; ++h) {
        if (h < n) {
#pragma unroll
          for (int j = 0; j < RPW; ++j) sw[(h * RPW + j) * K7_LDV + wl] = vr[h][j];
        }
      }
      ring.give_back();
#pragma unroll
      for (int h = 0; h < GR; ++h) {
#pragma unroll
        for (int j = 0; j < RPW; ++j) {
          // the row is below N: uniform over the warp
          if (h < n && (ti + h < T - 1 || warp + WARPS * j < last)) {
            const float va = vr[h][j];
            const float4* u4 = reinterpret_cast<const float4*>(sw + (h * RPW + j) * K7_LDV);
            w0 = fmaf(va, y[(ti + h) * K7_NB + warp + WARPS * j], w0);
#pragma unroll
            for (int q = 0; q < K7_NB / 4; ++q) {
              const float4 u = u4[q];
              g[4 * q] = fmaf(va, u.x, g[4 * q]);
              g[4 * q + 1] = fmaf(va, u.y, g[4 * q + 1]);
              g[4 * q + 2] = fmaf(va, u.z, g[4 * q + 2]);
              g[4 * q + 3] = fmaf(va, u.w, g[4 * q + 3]);
            }
          }
        }
      }
    }
    float4* gp4 = reinterpret_cast<float4*>(Gp + (size_t)(warp * K7_NB + wl) * K7_LDV);
#pragma unroll
    for (int q = 0; q < K7_NB / 4; ++q) {
      gp4[q] = make_float4(g[4 * q], g[4 * q + 1], g[4 * q + 2], g[4 * q + 3]);
    }
    wp[warp * K7_NB + wl] = w0;
    __syncthreads();
    // the warps' partials summed in their order, entries tid, tid + THREADS, ..
    // (every sum before the first store, which would wait for them in turn)
    float sum[K7_NB * K7_NB / THREADS];
#pragma unroll
    for (int k = 0; k < K7_NB * K7_NB / THREADS; ++k) {
      const int e = tid + k * THREADS;
      sum[k] = 0.0f;
#pragma unroll
      for (int u = 0; u < WARPS; ++u) {
        sum[k] += Gp[(size_t)(u * K7_NB + (e >> 5)) * K7_LDV + (e & 31)];
      }
    }
#pragma unroll
    for (int k = 0; k < K7_NB * K7_NB / THREADS; ++k) {
      G_f[(tid + k * THREADS) >> 5][(tid + k * THREADS) & 31] = sum[k];
    }
    if (tid < K7_NB) {
      float ws = 0.0f;
#pragma unroll
      for (int u = 0; u < WARPS; ++u) ws += wp[u * K7_NB + tid];
      w_s[tid] = ws;
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int j = 0; j < K7_NB; ++j) g[j] = G_f[wl][j];
      float wc = w_s[wl];
      // w_c = w0_c - sum_{j<c} G_cj t_j: lane j's t is final at step j
#pragma unroll
      for (int j = 0; j < K7_NB - 1; ++j) {
        const float tj = __shfl_sync(FULL_MASK, tc * wc, j);
        if (wl > j) wc = fmaf(-g[j], tj, wc);
      }
      t_s[wl] = tc * wc;
    }
    __syncthreads();
    // y -= V t on the warp's rows, a lane per row
    for (int i = wl; p0 + warp + WARPS * i < N; i += 32) {
      y[p0 + warp + WARPS * i] -= k7_dot32(sV + (size_t)i * K7_LDV, t_s);
    }
    __syncwarp();
  }

  // R x = y, column tiles from the last (ragged) one, one barrier a step:
  // in step t warp 0 applies column tile t + 1 to the rows of tile t (its
  // look-ahead) and solves diagonal tile t, while warps 1.. apply column
  // tile t + 1 to the rows above, a tile a warp and a lane a row. The tiles
  // stream through rings that overlay the buffers of Q^T v, so they start
  // once every warp is done with those.
  // the reciprocals of R's diagonal, here and not on the chain of the
  // diagonal solves (each of R's diagonal entries was kept by the lane
  // that staged it, before a barrier of its panel)
  for (int i = tid; i < Np; i += THREADS) dinv_s[i] = i < N ? 1.0f / dinv_s[i] : 1.0f;
  asm volatile("cp.async.wait_all;\n" ::: "memory");   // the Q^T slots' last (empty) groups
  __syncthreads();
  K7BackRing<WARPS> back;
  back.first = Gp + (size_t)warp * K7_BACK_SLOTS * K3_TILE;
  back.a = a;
  back.N = N;
  back.warp = warp;
  back.start(T, wl);
  for (int t = T - 1; t >= 0; --t) {
    const int r0 = t * K7_NB;
    if (warp == 0) {
      if (t + 1 < T) {
        float* slot = back.take();
        y[r0 + wl] -= k7_dot32_any(k3_row(slot, a, N, t, t + 1, wl), y + r0 + K7_NB);
        back.give_back(slot);
      }
      // the tile's rows and columns past N: the identity's (dinv: 1)
      float* slot = back.take();
      const float* row = k3_row(slot, a, N, t, t, wl);
      float d[K7_NB];
#pragma unroll
      for (int k = 0; k < K7_NB; ++k) {
        d[k] = (r0 + wl < N && r0 + k < N) ? row[k] : (k == wl ? 1.0f : 0.0f);
      }
      const float dinv = dinv_s[r0 + wl];
      back.give_back(slot);
      float yj = y[r0 + wl];
#pragma unroll
      for (int k = K7_NB - 1; k >= 0; --k) {
        if (wl == k) yj *= dinv;
        if (k > 0) {
          const float yk = __shfl_sync(FULL_MASK, yj, k);
          if (wl < k) yj = fmaf(-d[k], yk, yj);
        }
      }
      y[r0 + wl] = yj;
    } else if (t + 1 < T) {
      for (int i = warp - 1; i < t; i += WARPS - 1) {   // zeros past N
        float* slot = back.take();
        y[i * K7_NB + wl] -= k7_dot32_any(k3_row(slot, a, N, i, t + 1, wl), y + r0 + K7_NB);
        back.give_back(slot);
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < N; i += THREADS) x[(size_t)lane * N + i] = y[i];
}

constexpr size_t k7_max(size_t x, size_t y) { return x > y ? x : y; }

// dynamic shared memory of qr_solve_kernel<warps, group> at N
constexpr size_t k7_smem(int warps, int group, int N) {
  return sizeof(float) * (2 * (size_t)((N + K7_NB - 1) / K7_NB * K7_NB)
                          + k7_max((size_t)warps * K7_NB * (K7_LDV + 1)
                                       + (size_t)((N + K7_NB - 1) / K7_NB * K7_NB) * K7_LDV
                                       + (size_t)group * K7_NB * K7_SROW,
                                   (size_t)warps * K7_BACK_SLOTS * K3_TILE));
}

template <int WARPS, int GR>
int k7_launch(const void* qr, const void* tau, const void* v, void* x, int B, int N, int smem,
              void* stream) {
  if ((size_t)smem < k7_smem(WARPS, GR, N)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute((const void*)qr_solve_kernel<WARPS, GR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  qr_solve_kernel<WARPS, GR><<<B, WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const float*)qr, (const float*)tau, (const float*)v, (float*)x, N);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K4 advance_state: the step half of ip_step's kernel, from a direction that
// the caller computed (the block and the condensed KKT modes), replacing
// awebox_tpu/parallel/batch.py:449-512 (_advance_state) there. It computes
// what kernels.advance_state_plain computes, bit for bit: every operation
// elementwise in f64 in the plain version's order, minima exact in any
// order, through the step rule's helpers that ip_step_kernel calls too. One
// CTA of 16 warps per lane strides over the lane's variables and rows twice:
// the fraction-to-boundary ratios (one block reduction), then the updates. What bounds it: the launch and two passes over ~45 KB a lane
// (at n=280), all from the L2.
// ---------------------------------------------------------------------------

// Pointers of one advance_state call, in the order of kernels.ADVANCE_FIELDS.
struct AdvancePtrs {
  const double* dw;        // (B, n)
  const double* dy;        // (B, n_eq)
  const double* dlam;      // (B, n_ineq)
  const double* ds;        // (B, n_ineq)
  const double* dzl;       // (B, n)
  const double* dzu;       // (B, n)
  const uint8_t* ok;       // (B,) bool
  const double* err_d;     // (B,)
  const double* err_kkt;   // (B,)
  const double* w;         // (B, n)
  const double* s;         // (B, n_ineq)
  const double* y;         // (B, n_eq)
  const double* lam;       // (B, n_ineq)
  const double* zl;        // (B, n)
  const double* zu;        // (B, n)
  const double* mu;        // (B,)
  const double* lbw;       // (n,)
  const double* ubw;       // (n,)
  double* w_o;             // the new state, shaped as its inputs
  double* s_o;
  double* y_o;
  double* lam_o;
  double* zl_o;
  double* zu_o;
  double* mu_o;
  double* err_o;
};
static_assert(sizeof(AdvancePtrs) == 26 * sizeof(void*), "AdvancePtrs is an array of pointers");

__global__ void __launch_bounds__(K4_THREADS)
advance_state_kernel(AdvancePtrs p, int n, int n_eq, int n_ineq, double tau, double kappa_mu,
                     double mu_min) {
  __shared__ double red[2][K4_WARPS];
  const int lane = blockIdx.x, tid = threadIdx.x;
  const size_t on = (size_t)lane * n, oe = (size_t)lane * n_eq, oi = (size_t)lane * n_ineq;
  const double mu = p.mu[lane];
  double v[2] = {1.0, 1.0};   // ra, rz: ftb starts its min at 1
  for (int i = tid; i < n; i += K4_THREADS) {
    const double w = p.w[on + i];
    var_ratios(nmax(__dsub_rn(w, p.lbw[i]), 1e-20), nmax(__dsub_rn(p.ubw[i], w), 1e-20),
               p.dw[on + i], p.zl[on + i], p.zu[on + i], p.dzl[on + i], p.dzu[on + i], tau, v[0],
               v[1]);
  }
  for (int q = tid; q < n_ineq; q += K4_THREADS) {
    v[0] = nmin(v[0], ftb_ratio(p.s[oi + q], p.ds[oi + q], tau));
    v[1] = nmin(v[1], lam_ratio(p.lam[oi + q], p.dlam[oi + q], tau));
  }
  lane_reduce(v, red);
  const double alpha = nmin(v[0], 1.0), alpha_z = nmin(v[1], 1.0);

  for (int i = tid; i < n; i += K4_THREADS) {
    update_var(p.w[on + i], p.dw[on + i], p.zl[on + i], p.dzl[on + i], p.zu[on + i],
               p.dzu[on + i], p.lbw[i], p.ubw[i], alpha, alpha_z, mu, p.w_o + on + i,
               p.zl_o + on + i, p.zu_o + on + i);
  }
  for (int k = tid; k < n_eq; k += K4_THREADS) {
    p.y_o[oe + k] = update_y(p.y[oe + k], p.dy[oe + k], alpha);
  }
  for (int q = tid; q < n_ineq; q += K4_THREADS) {
    p.lam_o[oi + q] = update_lam(p.lam[oi + q], p.dlam[oi + q], alpha_z);
    p.s_o[oi + q] = update_s(p.s[oi + q], p.ds[oi + q], alpha);
  }
  if (tid == 0) {
    p.mu_o[lane] = update_mu(mu, p.err_d[lane], p.ok[lane] != 0, kappa_mu, mu_min);
    p.err_o[lane] = p.err_kkt[lane];
  }
}

// ---------------------------------------------------------------------------
// K8 block_factor: the two-level factor of the block-structured KKT system,
// replacing awebox_tpu/ocp/blockkkt.py:539-588 (per lane: the interval
// interiors' Cholesky, the coupling solve Xc = Li^-1 M_ic, the Schur
// products S = M_cc - Xc^T Xc, the reduced bordered system R assembled from
// them, and its Cholesky: five XLA ops, a dozen gathers), f64, as
// kernels.block_factor_plain.
//
// What bounds it: the chain of dependent pivots, ni a frame and nr in R
// (54 + 64 at n_k = 4, 54 + 108 at n_k = 8), then bytes: a lane needs the
// lower triangles of its n_k symmetric frames (149 KB at n_k = 4) and writes
// Li, Xc and L_R with their zeros (199 KB), 0.0017 ms at B = 16 on 3.35
// TB/s; its ~1.4 MFLOP are nothing to the card. What the design does:
// - a thread-block cluster per lane, one CTA (rank k) per frame k: the
//   frames' interiors are eliminated side by side, since only their Schur
//   complements meet, in R;
// - the frame permuted at copy-in: rank k copies frame k whole into shared
//   memory by 16-byte cp.async (8-byte where a segment is odd) in the order
//   [interior (ni) | x_k | x_{k+1} | border] and damps its owned diagonal
//   (a copy of the lower triangle alone issues as many warp-wide copies and
//   took longer: the copy-in waits on latency, not bytes),
//   so that the elimination is a plain partial Cholesky of the first ni
//   columns of an nloc x nloc SPD matrix, lower triangle only: its first ni
//   columns become [Li; Xc^T] and its trailing c x c block S, and no loop of
//   the elimination maps an index;
// - panels of KB8_W = 8 columns, right-looking (kb8_factor): warps 0 and 1
//   factor a panel in registers (warp 0 its first 32 rows: shuffles bring
//   the pivot and its multipliers, one rsqrt a column on the chain; warp 1
//   the rows below, from the multipliers warp 0 publishes a column at a
//   time); every warp then applies it to the next panel's columns, and
//   warps 0 and 1 factor that panel while the other warps apply it to the
//   rest of the trailing lower triangle (a look-ahead, two block barriers a
//   panel). An update takes 8 x 8 tiles (none above the diagonal) and
//   subtracts the panel's rank-8 product by two f64 tensor-core MMAs a tile
//   (mma.sync m8n8k4; an entry a thread by CUDA-core FMAs took longer on the
//   chain). The leading dimensions are 4 mod 8 doubles, so a fragment's 32
//   loads hit distinct banks;
// - R through distributed shared memory: each rank copies its S into a
//   buffer of its own and publishes its failure flag; after one cluster
//   barrier the ranks gather R's lower triangle from the ranks' S, rank k
//   the rows k, k + n_k, .. (an entry is its frames' terms summed in frame
//   order, k = 0 .. n_k - 1, so L_R does not depend on scheduling; frame 0's
//   x_0 slot maps nowhere), and store it into the space rank 0's frame used;
//   after a second cluster barrier the other ranks leave and rank 0 factors
//   R with the same panels.
// Everything is f64: the MMA rounds each product-sum as IEEE f64, in another
// order than the plain version (so Li, Xc and R agree to rounding, not bit
// for bit). A lane fails (ok = 0, L_R NaN) where a pivot is <= 0 or not
// finite, or Li or L_R has a non-finite entry, on any rank: after the
// first cluster barrier every rank reads every rank's flag.
// ---------------------------------------------------------------------------
constexpr int KB8_THREADS = 256;
constexpr int KB8_WARPS = KB8_THREADS / 32;
constexpr int KB8_W = 8;              // panel width: the MMA's two k = 4 steps
constexpr int KB8_CHUNKS = 5;         // 32-row chunks of a panel a lane holds: n <= 160
constexpr int KB8_MAX_CLUSTER = 16;   // frames a lane (a non-portable cluster size past 8)

// the position of frame variable r in the permuted frame [interior | x_k | x_{k+1} | border]
__device__ __forceinline__ int kb8_perm(int r, int nx, int ni) {
  return r < 2 * nx ? ni + r : (r < 2 * nx + ni ? r - 2 * nx : r);
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(double* dst, const double* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// d += a b over one 8 x 8 x 4 step: a = A[lane / 4][lane % 4], b = B[lane % 4][lane / 4],
// d = D[lane / 4][2 (lane % 4) + {0, 1}]
__device__ __forceinline__ void kb8_dmma(double& d0, double& d1, double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(d0), "+d"(d1) : "d"(a), "d"(b));
}

// rows r0 + wl + 32 t of the panel P (row r at P + r ld, 16-byte aligned)
// into a, columns past w and rows past n as zeros
template <int CH>
__device__ __forceinline__ void kb8_panel_load(double (&a)[CH][KB8_W], const double* P, int ld,
                                               int n, int r0, int w, int wl) {
#pragma unroll
  for (int t = 0; t < CH; ++t) {
    const int r = r0 + wl + 32 * t;
    const double2* src = reinterpret_cast<const double2*>(P + (size_t)r * ld);
#pragma unroll
    for (int h = 0; h < KB8_W / 2; ++h) {
      const double2 v = r < n ? src[h] : make_double2(0.0, 0.0);
      a[t][2 * h] = 2 * h < w ? v.x : 0.0;
      a[t][2 * h + 1] = 2 * h + 1 < w ? v.y : 0.0;
    }
  }
}

// a back to the panel's lower part: rows below the diagonal block (from p0 +
// KB8_W) of a full panel in 16-byte words, the rest entry by entry
template <int CH>
__device__ __forceinline__ void kb8_panel_store(const double (&a)[CH][KB8_W], double* P, int ld,
                                                int n, int p0, int r0, int w, int wl) {
#pragma unroll
  for (int t = 0; t < CH; ++t) {
    const int r = r0 + wl + 32 * t;
    double* row = P + (size_t)r * ld;
    if (r < n && w == KB8_W && r >= p0 + KB8_W) {
#pragma unroll
      for (int h = 0; h < KB8_W / 2; ++h) {
        reinterpret_cast<double2*>(row)[h] = make_double2(a[t][2 * h], a[t][2 * h + 1]);
      }
    } else if (r < n) {
#pragma unroll
      for (int j = 0; j < KB8_W; ++j) {
        if (j < w && r > p0 + j) row[j] = a[t][j];
      }
    }
  }
}

__device__ __forceinline__ void kb8_bar_arrive(int id) {
  asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void kb8_bar_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// Warps 0 and 1: the panel of columns p0 .. p0 + w - 1 (w <= KB8_W) of the
// n x n lower triangle A (leading dimension ld, even; p0 a multiple of 8),
// rows p0 .. n - 1, factored in registers: lane wl of warp 0 holds row
// p0 + wl (so pivot j sits in lane j), lane wl of warp 1 rows p0 + wl + 32 t,
// t = 1 .. KB8_CHUNKS - 1. Columns past w are zeros that run through the
// same straight-line code (a NaN there is never stored). The chain is warp
// 0's: an rsqrt, a product, an FMA and a shuffle a column (lane j + 1 forms
// pivot j + 1 from its own row and broadcasts it). Warp 0 publishes column
// j's 1 / sqrt(pivot) and multipliers in slot[j] and arrives at named
// barrier 1 + j without waiting; warp 1 waits there and applies them to its
// rows, a column behind. Writes the panel's lower part back, L_jj = d2
// rsqrt(d2); returns, in warp 0, whether a pivot was <= 0 or not finite.
__device__ bool kb8_panel(double* A, int ld, int n, int p0, int w, double* slot, int warp,
                          int wl) {
  double* P = A + p0;   // row r of the panel at P + r ld
  if (warp == 1) {
    double a[KB8_CHUNKS - 1][KB8_W];
    kb8_panel_load(a, P, ld, n, p0 + 32, w, wl);
#pragma unroll
    for (int j = 0; j < KB8_W; ++j) {
      kb8_bar_sync(1 + j);
      const double rs = slot[j * KB8_W];
#pragma unroll
      for (int t = 0; t < KB8_CHUNKS - 1; ++t) a[t][j] *= rs;
#pragma unroll
      for (int jj = j + 1; jj < KB8_W; ++jj) {
        const double l = slot[j * KB8_W + jj];
#pragma unroll
        for (int t = 0; t < KB8_CHUNKS - 1; ++t) a[t][jj] = fma(-a[t][j], l, a[t][jj]);
      }
    }
    kb8_panel_store(a, P, ld, n, p0, p0 + 32, w, wl);
    return false;
  }
  double a[1][KB8_W];
  kb8_panel_load(a, P, ld, n, p0, w, wl);
  double dg = 0.0;   // lane j < w: pivot j's square
  double d2 = __shfl_sync(FULL_MASK, a[0][0], 0);
#pragma unroll
  for (int j = 0; j < KB8_W; ++j) {
    if (wl == j) dg = d2;
    const double rs = rsqrt(d2);
    a[0][j] *= rs;                    // rows above pivot j: unused
    double d2n = 0.0;                 // the next pivot first: lane j + 1's update below
    if (j + 1 < KB8_W) d2n = __shfl_sync(FULL_MASK, fma(-a[0][j], a[0][j], a[0][j + 1]), j + 1);
    if (wl == 0) slot[j * KB8_W] = rs;
    if (wl > j && wl < KB8_W) slot[j * KB8_W + wl] = a[0][j];
    kb8_bar_arrive(1 + j);
#pragma unroll
    for (int jj = j + 1; jj < KB8_W; ++jj) {
      a[0][jj] = fma(-a[0][j], __shfl_sync(FULL_MASK, a[0][j], jj), a[0][jj]);
    }
    d2 = d2n;
  }
  kb8_panel_store(a, P, ld, n, p0, p0, w, wl);
  if (wl < w) A[(size_t)(p0 + wl) * (ld + 1)] = dg * rsqrt(dg);
  return __any_sync(FULL_MASK, wl < w && (!(dg > 0.0) || !isfinite(dg)));
}

// Warps w0 .. KB8_WARPS - 1: A[i][j] -= sum_{k < w} A[i][p0 + k] A[j][p0 + k]
// for the lower entries (j <= i < n, cl <= j < ch) of the 8 x 8 tiles (I, J)
// at origin o (rows o + 8 I .., columns o + 8 J ..): with strip the tiles
// (I, 0), otherwise every tile J <= I, dealt round-robin in row order; two
// tiles at a time, each by two MMAs (k = 0..3, 4..7; panel columns past w
// read as zero). Entries outside the mask are neither read nor written.
__device__ void kb8_update(double* A, int ld, int n, int p0, int w, int o, int cl, int ch,
                           bool strip, int w0, int warp, int wl) {
  const int nt = (n - o + 7) >> 3, step = KB8_WARPS - w0;
  const int g = wl >> 2, tg = wl & 3;
  int I = strip ? warp - w0 : 0, J = strip ? 0 : warp - w0;
  while (J > I) J -= ++I;
  while (I < nt) {
    int I2 = I + (strip ? step : 0), J2 = J + (strip ? 0 : step);
    while (J2 > I2) J2 -= ++I2;
    double c[2][2], a[2][2], b[2][2];
    int ra[2], cc[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int Iu = u ? I2 : I, Ju = u ? J2 : J;
      const bool tile = Iu < nt;
      ra[u] = tile ? o + 8 * Iu + g : n;
      cc[u] = o + 8 * Ju + 2 * tg;
      const int rb = o + 8 * Ju + g;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const bool kin = 4 * s + tg < w;
        a[u][s] = (ra[u] < n && kin) ? -A[(size_t)ra[u] * ld + p0 + 4 * s + tg] : 0.0;
        b[u][s] = (tile && rb < n && kin) ? A[(size_t)rb * ld + p0 + 4 * s + tg] : 0.0;
        const int j = cc[u] + s;
        c[u][s] = (ra[u] < n && j <= ra[u] && j >= cl && j < ch) ? A[(size_t)ra[u] * ld + j] : 0.0;
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      kb8_dmma(c[u][0], c[u][1], a[u][0], b[u][0]);
      kb8_dmma(c[u][0], c[u][1], a[u][1], b[u][1]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int j = cc[u] + s;
        if (ra[u] < n && j <= ra[u] && j >= cl && j < ch) A[(size_t)ra[u] * ld + j] = c[u][s];
      }
    }
    I = I2 + (strip ? step : 0);
    J = J2 + (strip ? 0 : step);
    while (J > I) J -= ++I;
  }
}

// The partial Cholesky of the first npiv columns of the n x n lower triangle
// A in panels of KB8_W, with a look-ahead: once panel p is factored, every
// warp applies it to panel p + 1's columns (one barrier), then warps 0 and 1
// factor panel p + 1 while the other warps apply panel p to the columns
// after it (a second barrier), so the bulk of the trailing update runs in
// the shadow of the next panel's chain. slot holds the panel's multipliers
// (KB8_W x KB8_W). flag is the block's
// shared failure word (0 on entry). Returns, uniformly over the block,
// whether a pivot failed (the panels after it are skipped).
__device__ bool kb8_factor(double* A, int ld, int n, int npiv, int* flag, double* slot, int warp,
                           int wl) {
  if (warp < 2 && kb8_panel(A, ld, n, 0, min(KB8_W, npiv), slot, warp, wl) && wl == 0) *flag = 1;
  __syncthreads();
  if (*flag) return true;
  for (int p0 = 0; p0 < npiv; p0 += KB8_W) {
    const int w = min(KB8_W, npiv - p0), q0 = p0 + w, wn = min(KB8_W, npiv - q0);
    if (wn > 0) {
      kb8_update(A, ld, n, p0, w, q0, q0, q0 + wn, true, 0, warp, wl);
      __syncthreads();
      if (warp < 2) {
        if (kb8_panel(A, ld, n, q0, wn, slot, warp, wl) && wl == 0) *flag = 1;
      } else {
        kb8_update(A, ld, n, p0, w, wn == KB8_W ? q0 + KB8_W : q0, q0 + wn, n, false, 2, warp,
                   wl);
      }
      __syncthreads();
      if (*flag) return true;
    } else {
      kb8_update(A, ld, n, p0, w, q0, q0, n, false, 0, warp, wl);
      __syncthreads();
    }
  }
  return false;
}

// A[i][j] for j <= i < n, zeros above the diagonal, to the row-major n x n
// dst (two entries a lane where n is even: the rows are then 16-byte
// aligned); returns whether an entry was not finite (this thread's)
__device__ __forceinline__ bool kb8_store_lower(double* __restrict__ dst, const double* A, int ld,
                                                int n, int warp, int wl) {
  bool bad = false;
  if ((n & 1) == 0) {
    for (int i = warp; i < n; i += KB8_WARPS) {
      for (int j = 2 * wl; j < n; j += 64) {
        const double2 s = *reinterpret_cast<const double2*>(A + (size_t)i * ld + j);
        const double2 v = make_double2(j <= i ? s.x : 0.0, j < i ? s.y : 0.0);
        bad |= !isfinite(v.x) || !isfinite(v.y);
        *reinterpret_cast<double2*>(dst + (size_t)i * n + j) = v;
      }
    }
    return bad;
  }
  for (int i = warp; i < n; i += KB8_WARPS) {
    for (int j = wl; j < n; j += 32) {
      const double v = j <= i ? A[(size_t)i * ld + j] : 0.0;
      bad |= !isfinite(v);
      dst[(size_t)i * n + j] = v;
    }
  }
  return bad;
}

__global__ void __launch_bounds__(KB8_THREADS, 2)
block_factor_kernel(const double* __restrict__ Frame, const double* __restrict__ delta,
                    const double* __restrict__ own_free, double* __restrict__ Li,
                    double* __restrict__ Xc, double* __restrict__ L_R, uint8_t* __restrict__ ok,
                    int n_k, int nx, int ni, int nb, int ldf, int ldr, int lds) {
  extern __shared__ double kb8_smem[];
  __shared__ double kb8_slot[KB8_W * KB8_W];         // a panel's multipliers, warp 0 to 1
  __shared__ int kb8_flag;                          // a panel's failed pivot
  __shared__ int kb8_bad;                           // this rank's failure, for the cluster
  __shared__ unsigned char kb8_blk[32 * KB8_CHUNKS];   // R index -> chain block (n_k: border)
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.block_rank();           // the frame
  const int nloc = 2 * nx + ni + nb, c = 2 * nx + nb, nr = n_k * nx + nb;
  const int lane = (int)blockIdx.x / n_k;
  double* F = kb8_smem;                              // the permuted frame; on rank 0 then R
  double* S = kb8_smem + max(nloc * ldf, nr * ldr);  // [c][lds], lower triangle
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;

  // 1. frame k in, permuted (16-byte copies where every segment is an even
  //    number of doubles), its owned diagonal damped
  const double* Fk = Frame + ((size_t)lane * n_k + k) * nloc * nloc;
  const bool pairs = ((ni | nb) & 1) == 0;
  for (int r = warp; r < nloc; r += KB8_WARPS) {
    double* row = F + (size_t)kb8_perm(r, nx, ni) * ldf;
    const double* src = Fk + (size_t)r * nloc;
    if (pairs) {
      for (int j = 2 * wl; j < nloc; j += 64) cp_async16(row + kb8_perm(j, nx, ni), src + j);
    } else {
      for (int j = wl; j < nloc; j += 32) cp_async8(row + kb8_perm(j, nx, ni), src + j);
    }
  }
  if (tid == 0) {
    kb8_flag = 0;
    kb8_bad = 0;
  }
  for (int b = 0; b <= n_k; ++b) {
    for (int o = tid; o < (b < n_k ? nx : nb); o += KB8_THREADS) {
      kb8_blk[b * nx + o] = (unsigned char)b;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const double dl = delta[lane];
  for (int r = tid; r < nloc; r += KB8_THREADS) {
    const int q = kb8_perm(r, nx, ni);
    F[(size_t)q * (ldf + 1)] = __dadd_rn(F[(size_t)q * (ldf + 1)],
                                         __dmul_rn(dl, own_free[k * nloc + r]));
  }
  __syncthreads();

  // 2. the interior's ni pivots
  bool failed = kb8_factor(F, ldf, nloc, ni, &kb8_flag, kb8_slot, warp, wl);

  // 3. Li, Xc (coupling order [x_k | x_{k+1} | border] = the permuted order)
  //    and S into its buffer
  bool bad = kb8_store_lower(Li + ((size_t)lane * n_k + k) * ni * ni, F, ldf, ni, warp, wl);
  double* Xk = Xc + ((size_t)lane * n_k + k) * ni * c;
  for (int i = warp; i < ni; i += KB8_WARPS) {
    for (int a = wl; a < c; a += 32) Xk[(size_t)i * c + a] = F[(size_t)(ni + a) * ldf + i];
  }
  for (int a = warp; a < c; a += KB8_WARPS) {
    for (int b = wl; b <= a; b += 32) S[a * lds + b] = F[(size_t)(ni + a) * ldf + ni + b];
  }
  failed = __syncthreads_or(failed || bad) != 0;
  if (tid == 0) kb8_bad = failed ? 1 : 0;
  cluster.sync();   // every rank's S and flag are published; rank 0's frame is spent

  // 4. R's lower triangle from the ranks' S, each entry its frames' terms
  //    summed in frame order, written into rank 0's shared memory: rank k
  //    gathers rows k, k + n_k, .. (skipped where a rank failed)
  failed = false;
  for (int q = 0; q < n_k; ++q) failed |= *cluster.map_shared_rank(&kb8_bad, q) != 0;
  if (!failed) {
    double* R = cluster.map_shared_rank(F, 0);
    const int x1 = nx, xb = 2 * nx;   // S positions of x_{k+1} and the border
    for (int i = k + n_k * warp; i < nr; i += n_k * KB8_WARPS) {
      const int bi = kb8_blk[i], oi = i - bi * nx;   // border: bi = n_k, oi = i - n_k nx
      for (int j = wl; j <= i; j += 32) {
        const int bj = kb8_blk[j], oj = j - bj * nx;
        double v = 0.0;
        if (bi == n_k && bj == n_k) {        // border x border: every frame
          for (int q = 0; q < n_k; ++q) {
            v += cluster.map_shared_rank(S, q)[(xb + oi) * lds + xb + oj];
          }
        } else if (bi == n_k) {              // border x x_{bj+1}: frames bj, bj + 1
          v = cluster.map_shared_rank(S, bj)[(xb + oi) * lds + x1 + oj];
          if (bj + 1 < n_k) v += cluster.map_shared_rank(S, bj + 1)[(xb + oi) * lds + oj];
        } else if (bi == bj) {               // x_{bi+1} x x_{bi+1}: frames bi, bi + 1
          v = cluster.map_shared_rank(S, bi)[(x1 + oi) * lds + x1 + oj];
          if (bi + 1 < n_k) v += cluster.map_shared_rank(S, bi + 1)[oi * lds + oj];
        } else if (bi == bj + 1) {           // x_{bi+1} x x_{bi}: frame bi
          v = cluster.map_shared_rank(S, bi)[(x1 + oi) * lds + oj];
        }
        R[(size_t)i * ldr + j] = v;
      }
    }
  }
  cluster.sync();   // R is whole in rank 0, and no rank reads another's S any more
  if (k != 0) return;

  // 5. rank 0: R factored, L_R out
  if (!failed) failed = kb8_factor(F, ldr, nr, nr, &kb8_flag, kb8_slot, warp, wl);
  double* LR = L_R + (size_t)lane * nr * nr;
  bad = !failed && kb8_store_lower(LR, F, ldr, nr, warp, wl);
  failed = __syncthreads_or(failed || bad) != 0;
  if (failed) {
    for (int t = tid; t < nr * nr; t += KB8_THREADS) LR[t] = __longlong_as_double(0x7ff8000000000000ll);
  }
  if (tid == 0) ok[lane] = failed ? 0 : 1;
}

// ---------------------------------------------------------------------------
// The substitutions of K9 and K11, f64: L x = b (ks_forward) and L^T x = b
// (ks_backward) of one lane by one CTA of KS_WARPS warps, L lower, in tiles
// of 32 x 32. A tile is staged in shared memory as 32 rows of KS_LDT doubles
// (16-byte rows: a warp reads a tile's column as pairs, and a tile's row,
// without bank conflicts), its entries outside the m x m matrix as zeros.
// Where the tiles come from is the source's business (take / done): K9
// holds its factors whole in shared memory (KsResident), K11 streams L
// through a ring of slots a warp (KsRing).
//
// Right-looking, step s solving row tile s (the backward pass walks the
// tiles from the last):
// - warp 0 runs the chain on the diagonal tile, a lane a row: x_j = b_j *
//   (1 / L_jj), the reciprocals formed once before the first step, then one
//   shuffle and one FMA a column. The diagonal tile and the tile that meets
//   the next rows (forward: tile (s + 1, s); backward: (s, s - 1)) are in
//   shared memory before the step starts, so no column step of the chain
//   issues a global load. The same column step folds x_j into the lane's
//   row of the next tile (an FMA off the chain): when the chain ends, the
//   next tile lacks nothing of this one.
// - meanwhile warps 1 .. 7 apply the previous tile's x to the rows after the
//   next (forward: tiles (i, s - 1), i > s; backward: (s + 1, i), i < s), a
//   tile at a time, dealt round-robin; a tile's 32 products in four
//   interleaved partial sums, (a0 + a1) + (a2 + a3), taken from y at once.
// - one block barrier a step.
// Every sum has a fixed order: row tile i takes the tiles of the columns
// two or more tiles away in the order of the steps, then the fold of the
// adjacent tile (its products in column order, from zero), then its chain.
// Rows past m stay zero and are never broadcast.
// ---------------------------------------------------------------------------
constexpr int KS_NB = 32;                    // tile width
constexpr int KS_LDT = 34;                   // doubles a staged tile row
constexpr int KS_TILE = KS_NB * KS_LDT;      // doubles a tile slot
constexpr int KS_THREADS = 256;
constexpr int KS_WARPS = KS_THREADS / 32;

// Phase stamps for probes/solve_chains.py, which builds the source with
// KS_STAMPS defined and its own stamps (lane 0 of warps 0 and 1 each add up
// the cycles since their last stamp); nothing here otherwise.
#ifndef KS_STAMPS
#define KS_STAMP_BEGIN()
#define KS_STAMP(i)
#define KS_STAMP_END()
#endif

__device__ __forceinline__ int ks_tiles(int m) { return (m + KS_NB - 1) / KS_NB; }

__device__ __forceinline__ void cp_async8_z(double* dst, const double* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

// wait until at most n (0 .. 3) of this thread's cp.async groups are pending
__device__ __forceinline__ void ks_wait_group(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// Threads q0, q0 + nq, .. copy tile (ti, tj) of the m x m row-major L
// (leading dimension ld) into dst, entries outside L as zeros (copies that
// read nothing). pairs: 16-byte copies (m and ld even, L 16-byte aligned).
__device__ __forceinline__ void ks_copy_tile(double* dst, const double* L, int ld, int m, int ti,
                                             int tj, bool pairs, int q0, int nq) {
  const int r0 = ti * KS_NB, c0 = tj * KS_NB;
  if (pairs) {
    for (int q = q0; q < KS_NB * KS_NB / 2; q += nq) {
      const int r = q >> 4, c = 2 * (q & 15);
      const bool in = r0 + r < m && c0 + c < m;
      cp_async16_zfill(reinterpret_cast<float*>(dst + r * KS_LDT + c),
                       reinterpret_cast<const float*>(in ? L + (size_t)(r0 + r) * ld + c0 + c : L),
                       in);
    }
  } else {
    for (int q = q0; q < KS_NB * KS_NB; q += nq) {
      const int r = q >> 5, c = q & 31;
      const bool in = r0 + r < m && c0 + c < m;
      cp_async8_z(dst + r * KS_LDT + c, in ? L + (size_t)(r0 + r) * ld + c0 + c : L,
                  in ? 8 : 0);
    }
  }
}

// The lower tiles (ti, tj), tj <= ti, held whole in shared memory, tile
// (ti, tj) at ti (ti + 1) / 2 + tj.
struct KsResident {
  const double* tiles;
  __device__ __forceinline__ const double* take(int ti, int tj) const {
    return tiles + (size_t)(ti * (ti + 1) / 2 + tj) * KS_TILE;
  }
  __device__ __forceinline__ void done() const {}
};

// The whole CTA stages the lower tiles of the m x m L (leading dimension m)
// in the layout KsResident reads (16-byte copies where pairs).
__device__ void ks_stage(double* tiles, const double* L, int m, bool pairs) {
  const int T = ks_tiles(m);
  for (int ti = 0, q = 0; ti < T; ++ti) {
    for (int tj = 0; tj <= ti; ++tj, ++q) {
      ks_copy_tile(tiles + (size_t)q * KS_TILE, L, m, m, ti, tj, pairs, threadIdx.x, KS_THREADS);
    }
  }
}

// The tiles a warp takes, in order: the idx-th of step s (s < T: forward
// step s; then backward, row tile 2T - 1 - s); false where there is none.
// Warp 0: the diagonal tile and the one it folds; warp w > 0: every
// (KS_WARPS - 1)-th of the other tiles, from the w-th.
__device__ __forceinline__ bool ks_step_tile(int s, int idx, int T, int warp, int& ti, int& tj) {
  if (s < T) {
    if (warp == 0) {
      ti = s + idx;
      tj = s;
      return idx == 0 || (idx == 1 && s + 1 < T);
    }
    ti = s + warp + (KS_WARPS - 1) * idx;
    tj = s - 1;
    return s > 0 && ti < T;
  }
  const int t = 2 * T - 1 - s;
  if (warp == 0) {
    ti = t;
    tj = t - idx;
    return idx == 0 || (idx == 1 && t > 0);
  }
  ti = t + 1;
  tj = t - warp - (KS_WARPS - 1) * idx;
  return ti < T && tj >= 0;
}

// A warp's ring of sw (<= 4) slots over the tiles it takes in both passes
// (ks_step_tile's order), as K3's: tile q lands in slot q % sw; giving a
// tile back issues the copy of the tile sw further on into its slot, so
// the copies run a step or more ahead of use and none is issued on the
// chain. One cp.async group a copy (empty once the walk is over): tile q
// has landed once at most sw - 1 - (tiles held) groups are pending.
struct KsRing {
  double* slots;
  const double* L;
  int m, T, sw, warp, wl;
  bool pairs;
  int s, idx;           // the next tile to copy (s == 2T: none left)
  int taken, freed;

  __device__ void advance() {
    int ti, tj;
    ++idx;
    while (s < 2 * T && !ks_step_tile(s, idx, T, warp, ti, tj)) {
      ++s;
      idx = 0;
    }
  }

  __device__ void issue(double* slot) {
    if (s < 2 * T) {
      int ti, tj;
      ks_step_tile(s, idx, T, warp, ti, tj);
      ks_copy_tile(slot, L, m, m, ti, tj, pairs, wl, 32);
      advance();
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  __device__ void start() {
    s = 0;
    idx = -1;
    advance();
    taken = freed = 0;
    for (int i = 0; i < sw; ++i) issue(slots + i * KS_TILE);
  }

  __device__ const double* take(int, int) {
    ks_wait_group(sw - 1 - (taken - freed));
    __syncwarp();
    return slots + (taken++ % sw) * KS_TILE;
  }

  __device__ void done() {
    __syncwarp();                       // every lane is done with the slots
    while (freed < taken) issue(slots + (freed++ % sw) * KS_TILE);
  }
};


// one column step j of warp 0's forward chain (d = L[row][j] of the
// diagonal tile, e = L[next row][j] of the tile below, r = 1 / L_rowrow)
__device__ __forceinline__ void ks_fwd_col(double& b, double& an, double d, double e, double r,
                                           int j, int h, int wl) {
  if (j < h) {
    if (wl == j) b *= r;
    const double xj = __shfl_sync(FULL_MASK, b, j);
    if (wl > j) b = fma(-d, xj, b);
    an = fma(-e, xj, an);
  }
}

// L y = b in place in y[0 .. 32T) (zeros past m), rinv[i] = 1 / L_ii (1 past
// m); ph: the stamps' phase of the chains (ph + 1: the step barriers)
template <class Src>
__device__ void ks_forward(Src& src, double* y, const double* rinv, int m, int ph, int warp,
                           int wl) {
  const int T = ks_tiles(m);
  double acc = 0.0;                     // warp 0: the fold into the lane's row of this tile
  for (int s = 0; s < T; ++s) {
    const int r0 = s * KS_NB;
    if (warp == 0) {
      const bool fold = s + 1 < T;
      const double* D = src.take(s, s) + wl * KS_LDT;
      const double* E = fold ? src.take(s + 1, s) + wl * KS_LDT : D;
      KS_STAMP(1);
      const int h = min(KS_NB, m - r0);
      const double r = rinv[r0 + wl];
      double b = y[r0 + wl] + acc, an = 0.0;
#pragma unroll
      for (int p = 0; p < KS_NB / 2; ++p) {
        const double2 d = *reinterpret_cast<const double2*>(D + 2 * p);
        const double2 e = fold ? *reinterpret_cast<const double2*>(E + 2 * p)
                               : make_double2(0.0, 0.0);
        ks_fwd_col(b, an, d.x, e.x, r, 2 * p, h, wl);
        ks_fwd_col(b, an, d.y, e.y, r, 2 * p + 1, h, wl);
      }
      if (wl < h) y[r0 + wl] = b;
      acc = an;
      KS_STAMP(ph);
      src.done();
      KS_STAMP(10);
    } else if (s > 0) {
      const double2* xs = reinterpret_cast<const double2*>(y + r0 - KS_NB);
      for (int i = s + warp; i < T; i += KS_WARPS - 1) {
        const double* M = src.take(i, s - 1) + wl * KS_LDT;
        KS_STAMP(1);
        double a[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
        for (int p = 0; p < KS_NB / 2; ++p) {
          const double2 v = *reinterpret_cast<const double2*>(M + 2 * p), x = xs[p];
          a[(2 * p) & 3] = fma(v.x, x.x, a[(2 * p) & 3]);
          a[(2 * p + 1) & 3] = fma(v.y, x.y, a[(2 * p + 1) & 3]);
        }
        if (i * KS_NB + wl < m) y[i * KS_NB + wl] -= (a[0] + a[1]) + (a[2] + a[3]);
        KS_STAMP(9);
        src.done();
        KS_STAMP(10);
      }
    }
    __syncthreads();
    KS_STAMP(ph + 1);
  }
}

// L^T y = b in place, as ks_forward
template <class Src>
__device__ void ks_backward(Src& src, double* y, const double* rinv, int m, int ph, int warp,
                            int wl) {
  const int T = ks_tiles(m);
  double acc = 0.0;
  for (int t = T - 1; t >= 0; --t) {
    const int r0 = t * KS_NB;
    if (warp == 0) {
      const bool fold = t > 0;
      const double* D = src.take(t, t) + wl;
      const double* E = fold ? src.take(t, t - 1) + wl : D;
      KS_STAMP(1);
      const int h = min(KS_NB, m - r0);
      const double r = rinv[r0 + wl];
      double b = y[r0 + wl] + acc, an = 0.0;
#pragma unroll
      for (int j = KS_NB - 1; j >= 0; --j) {
        if (j < h) {
          if (wl == j) b *= r;
          const double xj = __shfl_sync(FULL_MASK, b, j);
          if (wl < j) b = fma(-D[j * KS_LDT], xj, b);
          if (fold) an = fma(-E[j * KS_LDT], xj, an);
        }
      }
      if (wl < h) y[r0 + wl] = b;
      acc = an;
      KS_STAMP(ph);
      src.done();
      KS_STAMP(10);
    } else if (t + 1 < T) {
      const double2* xs = reinterpret_cast<const double2*>(y + r0 + KS_NB);
      for (int i = t - warp; i >= 0; i -= KS_WARPS - 1) {
        const double* M = src.take(t + 1, i) + wl;
        KS_STAMP(1);
        double a[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
        for (int p = 0; p < KS_NB / 2; ++p) {
          const double2 x = xs[p];
          a[(2 * p) & 3] = fma(M[2 * p * KS_LDT], x.x, a[(2 * p) & 3]);
          a[(2 * p + 1) & 3] = fma(M[(2 * p + 1) * KS_LDT], x.y, a[(2 * p + 1) & 3]);
        }
        y[i * KS_NB + wl] -= (a[0] + a[1]) + (a[2] + a[3]);
        KS_STAMP(9);
        src.done();
        KS_STAMP(10);
      }
    }
    __syncthreads();
    KS_STAMP(ph + 1);
  }
}

// ---------------------------------------------------------------------------
// K9 block_solve: M^-1 v through K8's factor, replacing
// awebox_tpu/ocp/blockkkt.py:646-679, f64, as kernels.block_solve_plain.
// What bounds it: the substitution chains, then the factor's bytes (a lane's
// lower triangles of Li and L_R and its Xc, ~75 KB at n_k = 4, once). The
// frames' interiors are independent until their coupling products meet in
// the reduced right-hand side, so a thread-block cluster of n_k CTAs a lane
// (kernels.block_solve_geometry) solves them side by side:
// - rank k stages frame k's Li_k (lower tiles) and Xc_k in its shared
//   memory, rank 0 also L_R's lower tiles (a second cp.async group that
//   lands while the interiors are solved), and the reciprocals of their
//   diagonals are formed ahead;
// - rank k solves its interior forward (ks_forward), forms Xc_k^T t_k (four
//   threads a coupling column, strided partial sums joined by two xor
//   shuffles) and writes it into rank 0's shared memory; one cluster
//   barrier;
// - rank 0 forms the reduced right-hand side in frame order (chain j takes
//   frame j's x_{k+1} slot and frame j + 1's x_k slot; the border every
//   frame's border slots, k = 0 .. n_k - 1), solves the reduced pair from
//   its shared memory and writes x_r into every rank; a second cluster
//   barrier;
// - rank k subtracts Xc_k [x_k; x_{k+1}; border] (four threads a row),
//   solves its interior backward and scatters its interior and chain block
//   (rank 0 the border).
// The chain is 2 + 2 + 2 + 2 tile steps at n_k = 4 (ni = 54, nr = 64) and
// 2 + 4 + 4 + 2 at n_k = 8, from 20 and 40 with the frames one after
// another. No rank reads another's shared memory: the products and x_r are
// written remotely before a barrier, so a rank may leave after the last.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(KS_THREADS, 2)
block_solve_kernel(const double* __restrict__ Li, const double* __restrict__ Xc,
                   const double* __restrict__ L_R, const double* __restrict__ rhs,
                   const long long* __restrict__ chain_V, const long long* __restrict__ intr_V,
                   const long long* __restrict__ border_V, double* __restrict__ x, int n_k,
                   int nx, int ni, int nb, int n, int ldx) {
  extern __shared__ double2 kb9_dyn[];
  KS_STAMP_BEGIN();
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.block_rank();          // the frame
  const int lane = (int)blockIdx.x / n_k;
  const int nr = n_k * nx + nb, c = 2 * nx + nb, nc = n_k * nx;
  const int Ti = ks_tiles(ni), Tr = ks_tiles(nr);
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  double* Lt = reinterpret_cast<double*>(kb9_dyn);     // Li_k's lower tiles
  double* Rt = Lt + (size_t)Ti * (Ti + 1) / 2 * KS_TILE;   // L_R's (rank 0)
  double* X = Rt + (size_t)Tr * (Tr + 1) / 2 * KS_TILE;    // Xc_k, ni rows at ldx (odd)
  double* t = X + ((ni * ldx + 1) & ~1);               // [32 Ti] the interior
  double* t_inv = t + Ti * KS_NB;                      // [32 Ti] 1 / Li_k's diagonal
  double* rr = t_inv + Ti * KS_NB;                     // [32 Tr] the reduced system, then x_r
  double* rr_inv = rr + Tr * KS_NB;                    // [32 Tr] 1 / L_R's diagonal (rank 0)
  double* upd = rr_inv + Tr * KS_NB;                   // [n_k][c] Xc_k^T t_k (rank 0)
  const double* Lk = Li + ((size_t)lane * n_k + k) * ni * ni;
  const double* Xk = Xc + ((size_t)lane * n_k + k) * ni * c;
  const double* LR = L_R + (size_t)lane * nr * nr;
  const double* v = rhs + (size_t)lane * n;

  // 1. copy-in: Li_k and Xc_k (one group), L_R on rank 0 (a second one); the
  //    right-hand sides gathered and the reciprocals formed meanwhile
  ks_stage(Lt, Lk, ni, (ni & 1) == 0 && ((uintptr_t)Li & 15) == 0);
  for (int q = tid; q < ni * c; q += KS_THREADS) {
    const int i = q / c;
    cp_async8(X + i * ldx + (q - i * c), Xk + q);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (k == 0) ks_stage(Rt, LR, nr, (nr & 1) == 0 && ((uintptr_t)L_R & 15) == 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = tid; i < Ti * KS_NB; i += KS_THREADS) {
    t[i] = i < ni ? v[intr_V[(size_t)k * ni + i]] : 0.0;
    t_inv[i] = i < ni ? 1.0 / Lk[(size_t)i * (ni + 1)] : 1.0;
  }
  if (k == 0) {
    for (int q = tid; q < Tr * KS_NB; q += KS_THREADS) {
      rr[q] = q < nc ? v[chain_V[q]] : (q < nr ? v[border_V[q - nc]] : 0.0);
      rr_inv[q] = q < nr ? 1.0 / LR[(size_t)q * (nr + 1)] : 1.0;
    }
  }
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();
  KS_STAMP(0);

  // 2. the interior forward, Xc_k^T t_k into rank 0's upd[k]
  KsResident li = {Lt};
  ks_forward(li, t, t_inv, ni, 2, warp, wl);
  double* upd0 = cluster.map_shared_rank(upd, 0);
  for (int base = 0; base < 4 * c; base += KS_THREADS) {
    const int q = base + tid, a = q >> 2;
    double s = 0.0;
    if (a < c) {
      for (int i = q & 3; i < ni; i += 4) s = fma(X[i * ldx + a], t[i], s);
    }
    s += __shfl_xor_sync(FULL_MASK, s, 1);
    s += __shfl_xor_sync(FULL_MASK, s, 2);
    if (a < c && (q & 3) == 0) upd0[k * c + a] = s;
  }
  KS_STAMP(6);
  cluster.sync();   // every frame's products are in rank 0
  KS_STAMP(7);

  // 3. rank 0: the reduced right-hand side in frame order, the reduced pair,
  //    x_r into every rank
  if (k == 0) {
    for (int q = tid; q < nr; q += KS_THREADS) {
      double val = rr[q];
      if (q < nc) {
        const int j = q / nx, a = q - j * nx;
        val -= upd[j * c + nx + a];
        if (j + 1 < n_k) val -= upd[(j + 1) * c + a];
      } else {
        double s = 0.0;
        for (int f = 0; f < n_k; ++f) s += upd[f * c + 2 * nx + (q - nc)];
        val -= s;
      }
      rr[q] = val;
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    KS_STAMP(6);
    KsResident lr = {Rt};
    ks_forward(lr, rr, rr_inv, nr, 4, warp, wl);
    ks_backward(lr, rr, rr_inv, nr, 4, warp, wl);
    for (int q = tid; q < (n_k - 1) * nr; q += KS_THREADS) {
      const int f = 1 + q / nr, i = q - (f - 1) * nr;
      cluster.map_shared_rank(rr, f)[i] = rr[i];
    }
    KS_STAMP(6);
  }
  cluster.sync();   // x_r is in every rank; nothing is read remotely after this
  KS_STAMP(7);

  // 4. t_k -= Xc_k [x_k; x_{k+1}; border] (frame 0's x_k slot reads the
  //    border's first nx), the interior backward, the scatter
  for (int base = 0; base < 4 * ni; base += KS_THREADS) {
    const int q = base + tid, i = q >> 2;
    double s = 0.0;
    if (i < ni) {
      for (int a = q & 3; a < c; a += 4) {
        const double xa = a < nx ? (k == 0 ? rr[nc + a] : rr[(k - 1) * nx + a])
                                 : (a < 2 * nx ? rr[k * nx + a - nx] : rr[nc + a - 2 * nx]);
        s = fma(X[i * ldx + a], xa, s);
      }
    }
    s += __shfl_xor_sync(FULL_MASK, s, 1);
    s += __shfl_xor_sync(FULL_MASK, s, 2);
    if (i < ni && (q & 3) == 0) t[i] -= s;
  }
  __syncthreads();
  KS_STAMP(6);
  ks_backward(li, t, t_inv, ni, 2, warp, wl);
  double* xo = x + (size_t)lane * n;
  for (int i = tid; i < ni; i += KS_THREADS) xo[intr_V[(size_t)k * ni + i]] = t[i];
  for (int a = tid; a < nx; a += KS_THREADS) xo[chain_V[(size_t)k * nx + a]] = rr[k * nx + a];
  if (k == 0) {
    for (int a = tid; a < nb; a += KS_THREADS) xo[border_V[a]] = rr[nc + a];
  }
  KS_STAMP(8);
  KS_STAMP_END();
}

// doubles of K9's dynamic shared memory a rank, as kernels.block_solve_geometry
size_t kb9_smem_doubles(int n_k, int nx, int ni, int nb, int ldx) {
  const int nr = n_k * nx + nb, c = 2 * nx + nb;
  const size_t Ti = (ni + KS_NB - 1) / KS_NB, Tr = (nr + KS_NB - 1) / KS_NB;
  return (Ti * (Ti + 1) / 2 + Tr * (Tr + 1) / 2) * KS_TILE + (((size_t)ni * ldx + 1) & ~(size_t)1)
      + 2 * KS_NB * (Ti + Tr) + (size_t)n_k * c;
}

// the launch: B clusters of n_k CTAs
cudaError_t kb9_attributes(int n_k, int smem) {
  const void* fn = (const void*)block_solve_kernel;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess || n_k <= 8) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

cudaLaunchConfig_t kb9_config(int B, int n_k, int smem, void* stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = k2c_config(B, n_k, smem, stream, attr);
  cfg.blockDim = dim3(KS_THREADS);
  return cfg;
}

// ---------------------------------------------------------------------------
// K10 chol_factor_batched: the Cholesky factor of the condensed M of each
// lane, replacing jnp.linalg.cholesky at awebox_tpu/parallel/batch.py:215-231,
// f64, lower with zeros above, as kernels.chol_factor_batched_plain. Two
// variants, chosen by n alone (kernels.chol_factor_geometry): the cluster
// variant below (chol_factor_cluster_kernel, n <= 554) and this one-CTA
// variant (global) for the lanes no cluster holds, up to n = 876.
// Global variant. What bounds it: the chain of pivots and one SM's
// shared-memory rate. A CTA per lane factors it right-looking in panels of
// K10_NB columns in its own output:
// it copies M's lower triangle there, then for each panel loads the panel's
// rows into shared memory (odd leading dimension, so a warp's column reads
// spread over the banks), factors it column by column (two block barriers a
// column), writes it back and subtracts the panel's product from the
// trailing lower triangle (each entry's 32 products summed from zero, then
// subtracted once), which stays in the L2. A pivot <= 0 or not finite, or a
// non-finite entry of L, fails the lane: ok = 0 and L is NaN.
// ---------------------------------------------------------------------------
constexpr int K10_NB = 32;
constexpr int K10_LD = K10_NB + 1;
constexpr int K10_THREADS = 256;

__global__ void __launch_bounds__(K10_THREADS, 1)
chol_factor_kernel(const double* __restrict__ M, double* __restrict__ L, uint8_t* __restrict__ ok,
                   int n) {
  extern __shared__ double P[];   // [n][K10_LD]: the panel's rows j0.. in rows 0..
  const int lane = blockIdx.x, tid = threadIdx.x;
  const double* A = M + (size_t)lane * n * n;
  double* Lw = L + (size_t)lane * n * n;
  for (int t = tid; t < n * n; t += K10_THREADS) {
    const int i = t / n, j = t - i * n;
    Lw[t] = j <= i ? A[t] : 0.0;
  }
  __syncthreads();
  bool failed = false;
  for (int j0 = 0; j0 < n && !failed; j0 += K10_NB) {
    const int w = min(K10_NB, n - j0), rows = n - j0;
    for (int t = tid; t < rows * K10_NB; t += K10_THREADS) {
      const int r = t / K10_NB, cc = t - r * K10_NB;
      P[r * K10_LD + cc] = cc < w ? Lw[(size_t)(j0 + r) * n + j0 + cc] : 0.0;
    }
    __syncthreads();
    for (int cc = 0; cc < w; ++cc) {
      const double d2 = P[cc * K10_LD + cc];
      if (!(d2 > 0.0) || !isfinite(d2)) {   // every thread reads the same pivot
        failed = true;
        break;
      }
      const double dp = sqrt(d2);
      for (int r = cc + 1 + tid; r < rows; r += K10_THREADS) P[r * K10_LD + cc] /= dp;
      __syncthreads();
      if (tid == 0) P[cc * K10_LD + cc] = dp;
      const int nc = w - cc - 1;   // panel columns right of cc
      for (int t = tid; t < (rows - cc - 1) * nc; t += K10_THREADS) {
        const int r = cc + 1 + t / nc, c2 = cc + 1 + t % nc;
        if (r >= c2) P[r * K10_LD + c2] = fma(-P[r * K10_LD + cc], P[c2 * K10_LD + cc],
                                              P[r * K10_LD + c2]);
      }
      __syncthreads();
    }
    if (failed) break;
    for (int t = tid; t < rows * w; t += K10_THREADS) {
      const int r = t / w, cc = t - r * w;
      if (r >= cc) Lw[(size_t)(j0 + r) * n + j0 + cc] = P[r * K10_LD + cc];
    }
    const int m2 = rows - w;
    for (int t = tid; t < m2 * m2; t += K10_THREADS) {
      const int i = t / m2, j = t - i * m2;
      if (j > i) continue;
      const double* pi = P + (w + i) * K10_LD;
      const double* pj = P + (w + j) * K10_LD;
      double acc = 0.0;
#pragma unroll 8
      for (int cc = 0; cc < K10_NB; ++cc) acc = fma(pi[cc], pj[cc], acc);
      double* e = Lw + (size_t)(j0 + w + i) * n + j0 + w + j;
      *e = *e - acc;
    }
    __syncthreads();
  }
  bool bad = false;
  if (!failed) {
    for (int t = tid; t < n * n; t += K10_THREADS) bad |= !isfinite(Lw[t]);
  }
  failed = __syncthreads_or(failed || bad) != 0;
  if (failed) {
    for (int t = tid; t < n * n; t += K10_THREADS) Lw[t] = __longlong_as_double(0x7ff8000000000000ll);
  }
  if (tid == 0) ok[lane] = failed ? 0 : 1;
}

// ---------------------------------------------------------------------------
// K10, cluster variant: the same function, a thread-block cluster of C CTAs
// per lane with the lane's lower triangle in the cluster's shared memory
// (kernels.chol_factor_geometry: the fewest of 4, 8 and 16 CTAs that hold
// it; 4 at n = 280, 16, a non-portable cluster, at n = 540).
// What bounds it: the chain of n pivots (a panel's diagonal block factored
// column by column, its rows handed to the next panel's owner, that panel
// updated by them), then the waves of clusters (an H100 runs 30 clusters of
// 4 CTAs at once, 7 of 16). A lane's n^3 / 6 FMAs (26 M at n = 540) are
// spread over C SMs' f64 tensor cores. What the design does:
// - panels of K10C_NB = 16 columns dealt block-cyclically over the ranks
//   (panel p to rank p % C); a panel is trapezoidal, its rows p NB .. n - 1
//   at leading dimension ld = 4 mod 8 doubles (20), so a fragment's loads
//   hit distinct banks; a rank's panels lie one after another
//   (k10c_rows_before), then a receive buffer for the panel being applied.
//   Only M's lower triangle is copied in (16-byte cp.async where both
//   entries lie on or below the diagonal and n is even), the entries above
//   the diagonal of a panel's diagonal block are zeros, and nothing reads
//   above the diagonal;
// - a panel's factor (k10c_panel): warp 0 holds rows 0 .. 31 of the panel,
//   a row a lane, and runs the chain on the 16 x 16 diagonal block in
//   registers (K8's kb8_panel: an rsqrt a column; lane j + 1 forms pivot
//   j + 1 from its own row and hands it on by a shuffle), publishing each
//   column's 1 / sqrt and multipliers in shared memory (which the warp's
//   lanes read the multipliers from) and arriving at a named barrier every
//   two columns; each thread of warps 1 .. 7 holds
//   two rows below and applies the columns as they come (a third row after
//   the chain). Every factored row goes from registers to its place in L;
// - L is the medium the ranks read panels from: a split cluster barrier
//   (K6's), one phase a panel, completes when every thread has arrived,
//   o(p) after it factored panel p, stored it and set its failure flag.
//   After the wait every rank reads o(p)'s flag, fetches the rows of panel
//   p below its first trailing column from the L2 (cp.async.cg into its
//   receive buffer) and arrives; its trailing panels are updated after the
//   arrive, in the shadow of the next panels' chains. Pulling a panel from
//   its owner's shared memory through distributed shared memory instead ran
//   at ~30-40 B a cycle out of the owner's SM, shared by every reader;
// - the look-ahead past the barrier: o(p) writes panel p's rows 16 .. 47
//   (o(p + 1)'s first 32 rows) back into its shared memory and, before it
//   stores anything to L (so that the release waits for no store to the
//   L2), arrives at an mbarrier in o(p + 1)'s shared memory. o(p + 1)'s
//   warp 0 waits there, copies those rows through distributed shared
//   memory, updates its rows 0 .. 31 by panel p and starts the chain of
//   panel p + 1, while warps 1 .. 7 wait for panel p's phase, fetch the
//   rest of panel p from L and update their rows;
// - the trailing updates on the f64 tensor cores: a warp takes two row
//   tiles of 8 of a panel at a time and updates their 8 x 8 tiles on or
//   below the diagonal (J = 0, 1; tile (0, 1) lies above it and is skipped)
//   by four m8n8k4 MMAs a tile, k = 0..3, 4..7, 8..11, 12..15 in this order
//   (kb8_dmma), each entry's 16 products summed from zero and subtracted
//   once; entries above the diagonal of a diagonal tile are neither read
//   nor written, and no index is divided per entry;
// - the zeros above each panel are stored once the lane is done, each rank
//   its panels' columns.
// Everything is f64 and in a fixed order, so two calls give the same bits
// and no lane depends on another. A lane fails (ok = 0, L NaN throughout)
// where a pivot is <= 0 or not finite (its owner's flag stops every rank
// after that panel's phase) or an entry of L is not finite: each rank
// publishes its flag, and after a cluster barrier every rank reads every
// flag; a second barrier keeps every rank until no one reads its shared
// memory.
// ---------------------------------------------------------------------------
constexpr int K10C_NB = 16;
constexpr int K10C_THREADS = 256;
constexpr int K10C_WARPS = K10C_THREADS / 32;
constexpr int K10C_MAX_CLUSTER = 16;

// rows held before a rank's local panel t: its panels r, r + C, .. hold rows p NB .. n - 1
__device__ __forceinline__ int k10c_rows_before(int t, int r, int C, int n) {
  return t * n - K10C_NB * (t * r + C * t * (t - 1) / 2);
}

// Row tiles I and I2 of T (the panel of columns q0 .. q0 + w - 1, h = n -
// q0 rows, row r at T + r ld) less the rank-16 product of the panel Pr (row
// i at Pr + (i - base) ld) on their 8 x 8 tiles on or below the diagonal: J
// = 0, 1 (tile (0, 1) lies above it); each entry's 16 products summed from
// zero by four MMAs, k = 0..3, 4..7, 8..11, 12..15 in this order, then
// subtracted once (an entry rounded once a panel, as LAPACK's blocked
// update does); entries above the diagonal neither read nor written. b:
// Pr's rows q0 .. q0 + 15 as B fragments.
__device__ __forceinline__ void k10c_tile_pair(double* T, const double* Pr, int ld, int h, int q0,
                                               int w, int base, int I, int I2,
                                               const double (&b)[2][4], int g, int tg) {
  double a[2][4], acc[2][2][2];
  int ri[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    ri[u] = 8 * (u ? I2 : I) + g;   // the fragment's row, from q0
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      a[u][s] = ri[u] < h ? Pr[(size_t)(q0 + ri[u] - base) * ld + 4 * s + tg] : 0.0;
    }
#pragma unroll
    for (int J = 0; J < 2; ++J) acc[u][J][0] = acc[u][J][1] = 0.0;
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int s = 0; s < 4; ++s) kb8_dmma(acc[u][0][0], acc[u][0][1], a[u][s], b[0][s]);
    if ((u ? I2 : I) > 0) {
#pragma unroll
      for (int s = 0; s < 4; ++s) kb8_dmma(acc[u][1][0], acc[u][1][1], a[u][s], b[1][s]);
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int J = 0; J < 2; ++J) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 8 * J + 2 * tg + e;
        if (ri[u] < h && j < w && j <= ri[u]) {
          double* t = T + (size_t)ri[u] * ld + j;
          *t = *t - acc[u][J][e];
        }
      }
    }
  }
}

// Pr's rows q0 .. q0 + 15 as the B fragments of an update of the panel at q0
__device__ __forceinline__ void k10c_bfrag(double (&b)[2][4], const double* Pr, int ld, int q0,
                                           int w, int base, int g, int tg) {
#pragma unroll
  for (int J = 0; J < 2; ++J) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      b[J][s] = 8 * J + g < w ? Pr[(size_t)(q0 + 8 * J + g - base) * ld + 4 * s + tg] : 0.0;
    }
  }
}

// T -= the rank-16 product of the panel Pr with itself on the lower 8 x 8
// tiles of the panel T: a warp takes the row tiles I and I + 8, I = warp,
// warp + 16, .., two at a time.
__device__ void k10c_update(double* T, const double* Pr, int ld, int n, int q0, int w, int base,
                            int warp, int wl) {
  const int g = wl >> 2, tg = wl & 3, h = n - q0, nt = (h + 7) >> 3;
  double b[2][4];
  k10c_bfrag(b, Pr, ld, q0, w, base, g, tg);
  for (int I = warp; I < nt; I += 2 * K10C_WARPS) {
    k10c_tile_pair(T, Pr, ld, h, q0, w, base, I, I + K10C_WARPS, b, g, tg);
  }
}

// Rows lo .. hi - 1 of panel k (its 16 columns at k0 = 16 k) from L, which
// its owner published, into recv (row i at recv + (i - base) ld) by the
// threads t0 .. t0 + nthr - 1, through the L2 (cp.async.cg where n is even);
// waits for this thread's copies
__device__ void k10c_fetch(double* recv, const double* Lw, int ld, int n, int k0, int lo, int hi,
                           int base, int t, int nthr) {
  if ((n & 1) == 0) {
    for (int e = t; e < (hi - lo) * (K10C_NB / 2); e += nthr) {
      const int i = lo + (e >> 3), c = 2 * (e & 7);
      const unsigned d = (unsigned)__cvta_generic_to_shared(recv + (size_t)(i - base) * ld + c);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   ::"r"(d), "l"(Lw + (size_t)i * n + k0 + c) : "memory");
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    for (int e = t; e < (hi - lo) * K10C_NB; e += nthr) {
      const int i = lo + (e >> 4), c = e & 15;
      recv[(size_t)(i - base) * ld + c] = __ldcg(Lw + (size_t)i * n + k0 + c);
    }
  }
}

// Row r (entries a[0 .. w - 1], zeros past the diagonal r) of a panel to L
// at dst; returns whether an entry was not finite
__device__ __forceinline__ bool k10c_put_row(double* __restrict__ dst, const double (&a)[K10C_NB],
                                             int w, int r, bool pairs) {
  bool bad = false;
  if (pairs && w == K10C_NB) {
#pragma unroll
    for (int j = 0; j < K10C_NB / 2; ++j) {
      const double2 v = make_double2(2 * j <= r ? a[2 * j] : 0.0,
                                     2 * j + 1 <= r ? a[2 * j + 1] : 0.0);
      bad |= !isfinite(v.x) || !isfinite(v.y);
      reinterpret_cast<double2*>(dst)[j] = v;
    }
    return bad;
  }
#pragma unroll
  for (int j = 0; j < K10C_NB; ++j) {
    if (j < w) {
      const double v = j <= r ? a[j] : 0.0;
      bad |= !isfinite(v);
      dst[j] = v;
    }
  }
  return bad;
}

// a panel's row of 16 from shared memory (zeros where not in)
__device__ __forceinline__ void k10c_load_row(double (&a)[K10C_NB], const double* row, bool in) {
#pragma unroll
  for (int j = 0; j < K10C_NB / 2; ++j) {
    const double2 v = in ? reinterpret_cast<const double2*>(row)[j] : make_double2(0.0, 0.0);
    a[2 * j] = v.x;
    a[2 * j + 1] = v.y;
  }
}

// a panel's row of 16 back to shared memory
__device__ __forceinline__ void k10c_store_row(double* row, const double (&a)[K10C_NB]) {
#pragma unroll
  for (int j = 0; j < K10C_NB / 2; ++j) {
    reinterpret_cast<double2*>(row)[j] = make_double2(a[2 * j], a[2 * j + 1]);
  }
}

// column J of a panel's factor on a row below its diagonal block: the
// pivot's 1 / sqrt from rs, the block's column J from lt (its L^T), two
// entries at a time
template <int J>
__device__ __forceinline__ void k10c_apply_col(double (&a)[K10C_NB], const double* rs,
                                               const double* lt) {
  a[J] *= rs[J];
#pragma unroll
  for (int jj = (J + 1) & ~1; jj < K10C_NB; jj += 2) {
    const double2 l = *reinterpret_cast<const double2*>(lt + J * K10C_NB + jj);
    if (jj > J) a[jj] = fma(-a[J], l.x, a[jj]);
    a[jj + 1] = fma(-a[J], l.y, a[jj + 1]);
  }
}

template <int J0, int J1>
__device__ __forceinline__ void k10c_apply_cols(double (&a)[K10C_NB], const double* rs,
                                                const double* lt) {
  if constexpr (J0 < J1) {
    k10c_apply_col<J0>(a, rs, lt);
    k10c_apply_cols<J0 + 1, J1>(a, rs, lt);
  }
}

__device__ __forceinline__ void k10c_bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(K10C_THREADS) : "memory");
}

__device__ __forceinline__ void k10c_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The handoff barrier: an mbarrier in this CTA's shared memory that the
// owner of the panel before each of this rank's panels arrives at once its
// rows q0 .. q0 + 31 (q0: this rank's panel's first row) lie in its shared
// memory. A wait that outlasts ~2^34 cycles traps, so that a fault of the
// protocol fails the launch instead of holding the card.
__device__ __forceinline__ void k10c_hbar_wait(uint64_t* bar, int parity) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  const long long t0 = clock64();
  unsigned done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void k10c_hbar_arrive_remote(uint64_t* bar, int rank) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("{\n .reg .b32 ra;\n mapa.shared::cluster.u32 ra, %0, %1;\n"
               " mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n}\n"
               ::"r"(a), "r"(rank) : "memory");
}

// The panel T (h = n - q0 rows from its diagonal, w <= 16 columns; h > 16
// implies w = 16) factored and published to L (row r at Lp + r n), zeros
// above its diagonal, by the whole block. With hsrc (the look-ahead, panel
// k = q0 / 16 - 1 applied first) warp 0 waits at the handoff barrier
// (parity), copies panel k's rows q0 .. q0 + 31 from its owner's shared
// memory (hsrc, row q0 + r at hsrc + r ld) into recv and updates rows 0 ..
// 31; warps 1 .. 7 wait for panel k's phase of the cluster barrier, fetch
// its rows q0 + 32 .. n - 1 from L (Lk, row i at Lk + i n; the block's later
// updates read them as well) and update the row tiles of the rows they
// factor; warp 0 waits for that phase after its chain. Warp 0 runs the
// chain on rows 0 .. 31 in registers (a row a lane; K8's kb8_panel: an
// rsqrt a column, lane j + 1 forming pivot j + 1 from its own row and
// handing it on by a shuffle) and publishes each column's 1 / sqrt (rs) and
// multipliers (lt, the diagonal block's L^T, which its lanes read the
// multipliers from, 2-5% faster than a shuffle each), arriving at a named
// barrier every two columns; each thread of warps 1 .. 7 holds rows
// tid and tid + 224 and applies the columns as they come, then sweeps row
// tid + 448. Where a panel follows (next >= 0: its owner's rank), rows 16
// .. 47 go back into T and, once warps 0 and 1 have written them, thread 0
// arrives at the next owner's handoff barrier; then every row goes to L
// from registers (after the handoff, so that its release waits for no
// store to the L2). Returns, uniformly over the block, whether a pivot was
// <= 0 or not finite; bad gathers this thread's non-finite stores.
__device__ bool k10c_panel(double* T, double* recv, const double* hsrc, const double* Lk,
                           uint64_t* hbar, int parity, int next, int ld, int n, int q0, int w,
                           double* rs, double* lt, double* __restrict__ Lp, bool& bad, int tid) {
  const int warp = tid >> 5, wl = tid & 31, g = wl >> 2, tg = wl & 3;
  const int h = n - q0;
  const bool pairs = (n & 1) == 0;
  bool fail = false;
  if (warp == 0) {
    if (hsrc != nullptr) {
      k10c_hbar_wait(hbar, parity);
      if (wl < h) {
        const double2* src = reinterpret_cast<const double2*>(hsrc + (size_t)wl * ld);
        double2 v[K10C_NB / 2];
#pragma unroll
        for (int j = 0; j < K10C_NB / 2; ++j) v[j] = src[j];
        double2* dst = reinterpret_cast<double2*>(recv + (size_t)wl * ld);
#pragma unroll
        for (int j = 0; j < K10C_NB / 2; ++j) dst[j] = v[j];
      }
      k10c_bar_arrive(9);   // panel k's rows q0 .. q0 + 31 are in recv
      __syncwarp();
      double b[2][4];
      k10c_bfrag(b, recv, ld, q0, w, q0, g, tg);
      k10c_tile_pair(T, recv, ld, h, q0, w, q0, 0, 1, b, g, tg);
      k10c_tile_pair(T, recv, ld, h, q0, w, q0, 2, 3, b, g, tg);
      __syncwarp();
    }
    double a[K10C_NB];
    k10c_load_row(a, T + (size_t)wl * ld, wl < h);
#pragma unroll
    for (int j = 0; j < K10C_NB; ++j) {
      if (j >= w) a[j] = 0.0;
    }
    double dg = 0.0;   // lane j < w: pivot j's square
    double d2 = __shfl_sync(FULL_MASK, a[0], 0);
#pragma unroll
    for (int j = 0; j < K10C_NB; ++j) {
      if (j < w) {
        if (wl == j) dg = d2;
        const double r = rsqrt(d2);
        a[j] *= r;
        double d2n = 0.0;   // the next pivot first: lane j + 1's update below
        if (j + 1 < K10C_NB) d2n = __shfl_sync(FULL_MASK, fma(-a[j], a[j], a[j + 1]), j + 1);
        if (wl == 0) rs[j] = r;
        if (wl > j && wl < K10C_NB) lt[j * K10C_NB + wl] = a[j];
        __syncwarp();
#pragma unroll
        for (int jj = j + 1; jj < K10C_NB; ++jj) a[jj] = fma(-a[j], lt[j * K10C_NB + jj], a[jj]);
        d2 = d2n;
      }
      if (j & 1) k10c_bar_arrive(1 + (j >> 1));   // columns j - 1 and j are out
    }
    if (wl < K10C_NB) {
      const double ljj = dg * rsqrt(dg);
#pragma unroll
      for (int j = 0; j < K10C_NB; ++j) {
        if (j == wl) a[j] = ljj;
      }
    }
    if (next >= 0) {
      if (wl >= K10C_NB && wl < h) k10c_store_row(T + (size_t)wl * ld, a);
      k10c_bar_sync(10, 64);
      if (wl == 0) k10c_hbar_arrive_remote(hbar, next);
    }
    if (wl < h) bad |= k10c_put_row(Lp + (size_t)wl * n, a, w, wl, pairs);
    fail = __any_sync(FULL_MASK, wl < w && (!(dg > 0.0) || !isfinite(dg)));
    if (hsrc != nullptr) k6_cluster_wait();   // panel k's phase
  } else {
    const int i0 = tid, i1 = tid + 224, i2 = tid + 448;   // this thread's rows
    if (hsrc != nullptr) {
      k6_cluster_wait();                // panel k's phase: its rows are in L
      if (q0 + 32 < n) k10c_fetch(recv, Lk, ld, n, 0, q0 + 32, n, q0, tid - 32, 224);
      k10c_bar_sync(9, K10C_THREADS);   // and warp 0's
      double b[2][4];
      k10c_bfrag(b, recv, ld, q0, w, q0, g, tg);
#pragma unroll
      for (int grp = 0; grp < 3; ++grp) {
        const int I = 4 * warp + 28 * grp;   // the row tiles of rows 32 warp + 224 grp ..
        if (8 * I < h) {
          k10c_tile_pair(T, recv, ld, h, q0, w, q0, I, I + 1, b, g, tg);
          k10c_tile_pair(T, recv, ld, h, q0, w, q0, I + 2, I + 3, b, g, tg);
        }
      }
      __syncwarp();
    }
    double a[K10C_NB], c[K10C_NB];
    k10c_load_row(a, T + (size_t)i0 * ld, i0 < h);
    k10c_load_row(c, T + (size_t)i1 * ld, i1 < h);
    k10c_bar_sync(1, K10C_THREADS); k10c_apply_cols<0, 2>(a, rs, lt); k10c_apply_cols<0, 2>(c, rs, lt);
    k10c_bar_sync(2, K10C_THREADS); k10c_apply_cols<2, 4>(a, rs, lt); k10c_apply_cols<2, 4>(c, rs, lt);
    k10c_bar_sync(3, K10C_THREADS); k10c_apply_cols<4, 6>(a, rs, lt); k10c_apply_cols<4, 6>(c, rs, lt);
    k10c_bar_sync(4, K10C_THREADS); k10c_apply_cols<6, 8>(a, rs, lt); k10c_apply_cols<6, 8>(c, rs, lt);
    k10c_bar_sync(5, K10C_THREADS); k10c_apply_cols<8, 10>(a, rs, lt); k10c_apply_cols<8, 10>(c, rs, lt);
    k10c_bar_sync(6, K10C_THREADS); k10c_apply_cols<10, 12>(a, rs, lt); k10c_apply_cols<10, 12>(c, rs, lt);
    k10c_bar_sync(7, K10C_THREADS); k10c_apply_cols<12, 14>(a, rs, lt); k10c_apply_cols<12, 14>(c, rs, lt);
    k10c_bar_sync(8, K10C_THREADS); k10c_apply_cols<14, 16>(a, rs, lt); k10c_apply_cols<14, 16>(c, rs, lt);
    if (next >= 0 && warp == 1) {
      if (wl < K10C_NB && i0 < h) k10c_store_row(T + (size_t)i0 * ld, a);
      k10c_bar_sync(10, 64);
    }
    if (i0 < h) bad |= k10c_put_row(Lp + (size_t)i0 * n, a, K10C_NB, i0, pairs);
    if (i1 < h) bad |= k10c_put_row(Lp + (size_t)i1 * n, c, K10C_NB, i1, pairs);
    if (i2 < h) {
      k10c_load_row(a, T + (size_t)i2 * ld, true);
      k10c_apply_cols<0, K10C_NB>(a, rs, lt);
      bad |= k10c_put_row(Lp + (size_t)i2 * n, a, K10C_NB, i2, pairs);
    }
  }
  return __syncthreads_or(fail) != 0;
}

// Rows 0 .. q0 - 1 of each of a rank's panels' columns as zeros or, with
// nan, every row as NaN
__device__ void k10c_fill(double* __restrict__ Lw, int n, int rank, int C, int n_local, bool nan,
                          int tid) {
  const double v = nan ? __longlong_as_double(0x7ff8000000000000ll) : 0.0;
  for (int t = 0; t < n_local; ++t) {
    const int q0 = (rank + t * C) * K10C_NB, w = min(K10C_NB, n - q0), rows = nan ? n : q0;
    for (int e = tid; e < rows * w; e += K10C_THREADS) {
      const int i = e / w;
      Lw[(size_t)i * n + q0 + e - i * w] = v;
    }
  }
}

__global__ void __launch_bounds__(K10C_THREADS, 1)
chol_factor_cluster_kernel(const double* __restrict__ M, double* __restrict__ L,
                           uint8_t* __restrict__ ok, int n, int ld, int recv_off) {
  extern __shared__ double2 k10c_dyn[];
  __shared__ double k10c_rs[K10C_NB];   // the pivots' 1 / sqrt of the panel factored last
  __shared__ __align__(16) double k10c_lt[K10C_NB * K10C_NB];   // its diagonal block's L^T
  __shared__ int k10c_fail;             // a panel of this rank failed (read after its phase)
  __shared__ int k10c_bad;              // this rank failed or published a non-finite entry
  __shared__ uint64_t k10c_hbar;        // the handoff barrier of this rank's panels
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.dim_blocks().x, rank = (int)cluster.block_rank();
  const int lane = (int)blockIdx.x / C;
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int P = (n + K10C_NB - 1) / K10C_NB;
  const int n_local = (P - rank + C - 1) / C;
  double* S = reinterpret_cast<double*>(k10c_dyn);   // this rank's panels
  double* recv = S + recv_off;                       // row i of the applied panel at row i - (k + 1) NB
  const double* A = M + (size_t)lane * n * n;
  double* Lw = L + (size_t)lane * n * n;

  // 1. the lower triangle of this rank's panels in; zeros above the diagonal
  for (int t = 0; t < n_local; ++t) {
    const int q0 = (rank + t * C) * K10C_NB, w = min(K10C_NB, n - q0), h = n - q0;
    double* T = S + (size_t)k10c_rows_before(t, rank, C, n) * ld;
    if ((n & 1) == 0) {
      for (int e = tid; e < h * (K10C_NB / 2); e += K10C_THREADS) {
        const int r = e >> 3, c = 2 * (e & 7);
        double* dst = T + (size_t)r * ld + c;
        const double* src = A + (size_t)(q0 + r) * n + q0 + c;
        if (c + 1 < w && c + 1 <= r) {
          cp_async16(dst, src);
        } else {
          dst[0] = (c < w && c <= r) ? src[0] : 0.0;
          dst[1] = 0.0;
        }
      }
    } else {
      for (int e = tid; e < h * K10C_NB; e += K10C_THREADS) {
        const int r = e >> 4, c = e & 15;
        double* dst = T + (size_t)r * ld + c;
        if (c < w && c <= r) {
          cp_async8(dst, A + (size_t)(q0 + r) * n + q0 + c);
        } else {
          *dst = 0.0;
        }
      }
    }
  }
  if (tid == 0) {
    k10c_fail = 0;
    k10c_bad = 0;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 ::"r"((unsigned)__cvta_generic_to_shared(&k10c_hbar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  cluster.sync();                       // every rank's handoff barrier is ready

  // 2. panel 0 by rank 0 before the first phase; then a phase a panel
  bool bad = false;   // this thread published a non-finite entry
  if (rank == 0 && k10c_panel(S, recv, nullptr, nullptr, &k10c_hbar, 0, P > 1 ? 1 : -1, ld, n, 0,
                              min(K10C_NB, n), k10c_rs, k10c_lt, Lw, bad, tid) && tid == 0) {
    k10c_fail = 1;
  }
  k6_cluster_arrive();
  bool failed = false;
  for (int k = 0; k < P; ++k) {
    const int owner = k % C;
    const int t0 = k < rank ? 0 : (k - rank) / C + 1;   // this rank's first panel after k
    int t_rest = t0;
    if (k + 1 < P && rank == (k + 1) % C) {   // the look-ahead: panel k + 1 is local panel t0
      const int q0 = (k + 1) * K10C_NB;
      const double* hsrc = cluster.map_shared_rank(S, owner)
          + (size_t)(k10c_rows_before(k / C, owner, C, n) + K10C_NB) * ld;
      if (k10c_panel(S + (size_t)k10c_rows_before(t0, rank, C, n) * ld, recv, hsrc,
                     Lw + (size_t)k * K10C_NB, &k10c_hbar, (rank > 0 ? t0 : t0 - 1) & 1,
                     k + 2 < P ? (k + 2) % C : -1, ld, n, q0, min(K10C_NB, n - q0), k10c_rs,
                     k10c_lt, Lw + (size_t)q0 * (n + 1), bad, tid) && tid == 0) {
        k10c_fail = 1;
      }
      // every thread has waited for panel k's phase
      if (*cluster.map_shared_rank(&k10c_fail, owner)) {
        failed = true;
        break;
      }
      t_rest = t0 + 1;
    } else {
      k6_cluster_wait();                // panel k is published
      if (*cluster.map_shared_rank(&k10c_fail, owner)) {
        failed = true;
        break;
      }
      if (k == P - 1) break;
      if (t0 < n_local) {               // uniform over the block
        k10c_fetch(recv, Lw, ld, n, k * K10C_NB, (rank + t0 * C) * K10C_NB, n, (k + 1) * K10C_NB,
                   tid, K10C_THREADS);
        __syncthreads();
      }
    }
    k6_cluster_arrive();                // panel k read; panel k + 1 published if ours
    for (int t = t_rest; t < n_local; ++t) {
      const int q0 = (rank + t * C) * K10C_NB;
      k10c_update(S + (size_t)k10c_rows_before(t, rank, C, n) * ld, recv, ld, n, q0,
                  min(K10C_NB, n - q0), (k + 1) * K10C_NB, warp, wl);
    }
    __syncthreads();                    // recv is free for the next panel
  }

  // 3. zeros above the panels; the flags exchanged
  if (!failed) k10c_fill(Lw, n, rank, C, n_local, false, tid);
  bad = __syncthreads_or(failed || bad) != 0;
  if (tid == 0) k10c_bad = bad ? 1 : 0;
  cluster.sync();                       // every rank's flag is published
  bool any = false;
  for (int q = 0; q < C; ++q) any |= *cluster.map_shared_rank(&k10c_bad, q) != 0;
  cluster.sync();                       // no rank reads another's shared memory any more
  if (any) k10c_fill(Lw, n, rank, C, n_local, true, tid);
  if (rank == 0 && tid == 0) ok[lane] = any ? 0 : 1;
}

// the cluster variant's launch: the attributes a launch needs and its configuration,
// B clusters of C CTAs
cudaError_t k10c_attributes(int C, int smem) {
  const void* fn = (const void*)chol_factor_cluster_kernel;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess || C <= 8) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

cudaLaunchConfig_t k10c_config(int B, int C, int smem, void* stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = k2c_config(B, C, smem, stream, attr);
  cfg.blockDim = dim3(K10C_THREADS);
  return cfg;
}

// ---------------------------------------------------------------------------
// K11 chol_solve_batched: x = L^-T L^-1 b through K10's factor, replacing
// msolve at awebox_tpu/parallel/batch.py:234-236 (two solve_triangular), f64,
// as kernels.chol_solve_batched_plain. What bounds it: the substitution
// chains (ceil(n / 32) tile steps each way), then L's bytes (its lower
// triangle, 314 KB a lane at n = 280, read once each way). One CTA a lane
// (kernels.chol_solve_geometry): the vector and the reciprocals of L's
// diagonal in shared memory, and L streamed through K11_RING tile slots by
// cp.async, each warp keeping the tiles it takes next in flight in a ring of
// its own (KsRing: warp 0 the diagonal and fold tiles of its next two steps,
// warps 1 .. 7 two tiles each), across both passes: ks_forward, then
// ks_backward.
// ---------------------------------------------------------------------------
constexpr int K11_SLOTS0 = 4;   // warp 0's ring: the diagonal and fold tiles of two steps
constexpr int K11_SLOTS = 2;    // the ring of each of warps 1 .. 7
constexpr int K11_RING = K11_SLOTS0 + (KS_WARPS - 1) * K11_SLOTS;

__global__ void __launch_bounds__(KS_THREADS, 1)
chol_solve_kernel(const double* __restrict__ L, const double* __restrict__ b,
                  double* __restrict__ x, int n) {
  extern __shared__ double2 k11_dyn[];
  KS_STAMP_BEGIN();
  const int T = ks_tiles(n), lane = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  double* slots = reinterpret_cast<double*>(k11_dyn);
  double* y = slots + (size_t)K11_RING * KS_TILE;   // [32 T], zeros past n
  double* rinv = y + T * KS_NB;                     // [32 T], ones past n
  const double* Ll = L + (size_t)lane * n * n;
  KsRing ring;
  ring.slots = slots + (warp == 0 ? 0 : K11_SLOTS0 + (warp - 1) * K11_SLOTS) * KS_TILE;
  ring.L = Ll;
  ring.m = n;
  ring.T = T;
  ring.sw = warp == 0 ? K11_SLOTS0 : K11_SLOTS;
  ring.warp = warp;
  ring.wl = wl;
  ring.pairs = (n & 1) == 0 && ((uintptr_t)L & 15) == 0;
  ring.start();
  for (int i = tid; i < T * KS_NB; i += KS_THREADS) {
    y[i] = i < n ? b[(size_t)lane * n + i] : 0.0;
    rinv[i] = i < n ? 1.0 / Ll[(size_t)i * (n + 1)] : 1.0;
  }
  __syncthreads();
  KS_STAMP(0);
  ks_forward(ring, y, rinv, n, 2, warp, wl);
  ks_backward(ring, y, rinv, n, 2, warp, wl);
  for (int i = tid; i < n; i += KS_THREADS) x[(size_t)lane * n + i] = y[i];
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  KS_STAMP(8);
  KS_STAMP_END();
}

// doubles of K11's dynamic shared memory at n, as kernels.chol_solve_geometry
size_t k11_smem_doubles(int n) {
  return (size_t)K11_RING * KS_TILE + 2 * KS_NB * (size_t)((n + KS_NB - 1) / KS_NB);
}

// ---------------------------------------------------------------------------
// K12 lu_factor_f64: replaces jax.scipy.linalg.lu_factor of the host
// solver's augmented KKT matrix at awebox_tpu/opti/ipsolver.py:194, f64, as
// kernels.lu_factor_f64_plain (LAPACK getrf: partial pivoting, the first
// maximum |a| of a column, 1-based int32 pivots, L unit lower and U in
// place). It is K2's blocked trio (lu_panel_kernel, lu_swap_kernel,
// lu_update_kernel, lu_blocked_launch) instantiated at T = double and
// panels of K12_NB = 16 columns: the lane stays in global memory and the
// panel kernel, one CTA of 16 warps per lane, holds the panel's rows
// k0..N-1 in shared memory (69 KB at N = 543, 135 KB at N = 1055); the
// pivot key is |a|'s 64 bits plus one (0 for a NaN, so a NaN is never
// chosen; ties to the lowest row), reduced by xor shuffles since redux.sync
// takes 32 bits.
// A zero pivot is divided by, so a singular lane's factor holds inf or NaN
// below it and its solve is not finite; a NaN lane stays NaN. Nothing is
// atomic and every sum runs in a fixed order: a lane's bits do not depend on
// the batch. What bounds it on the host solver's path (B = 1): the chain of
// N pivot steps of the panels, each two block barriers on one SM, and
// 3 ceil(N / 16) launches; the update's 2/3 N^3 operations spread over the
// card.
// ---------------------------------------------------------------------------
constexpr int K12_NB = 16;                    // panel width: 16 warps in the panel kernel

// ---------------------------------------------------------------------------
// K13 lu_solve_f64: x = lu_solve((lu, piv), b), replacing
// jax.scipy.linalg.lu_solve at awebox_tpu/opti/ipsolver.py:195 and :197,
// f64, as kernels.lu_solve_f64_plain. One CTA of KS_WARPS warps a lane, in
// K11's layout (kernels.lu_solve_f64_geometry): the vector, the pivots and
// the reciprocals of U's diagonal in shared memory, the factor streamed
// through K11_RING tile slots by cp.async. The row interchanges are applied
// to the vector in order by one thread, from shared memory; then the
// unit-lower forward pass is K9's and K11's ks_forward on the factor's
// strictly lower tiles with a diagonal of ones, and the upper backward pass
// is its mirror on U's tiles read as rows (k13_backward), each warp's ring
// (K13Ring) walking the lower tiles of the forward pass and the upper ones
// of the backward pass. What bounds it: the two chains of ceil(N / 32) tile
// steps, then the serial interchanges (N shared-memory swaps), then the
// factor's bytes (2.36 MB at N = 543, read once).
// ---------------------------------------------------------------------------

// KsRing's walk with the backward pass's tiles transposed: tile (ti, tj) of
// ks_step_tile's backward half is U's tile (tj, ti)
struct K13Ring {
  double* slots;
  const double* L;
  int m, T, sw, warp, wl;
  bool pairs;
  int s, idx;
  int taken, freed;

  __device__ void advance() {
    int ti, tj;
    ++idx;
    while (s < 2 * T && !ks_step_tile(s, idx, T, warp, ti, tj)) {
      ++s;
      idx = 0;
    }
  }

  __device__ void fetch(double* slot) {
    if (s < 2 * T) {
      int ti, tj;
      ks_step_tile(s, idx, T, warp, ti, tj);
      if (s >= T) {
        const int t = ti;
        ti = tj;
        tj = t;
      }
      ks_copy_tile(slot, L, m, m, ti, tj, pairs, wl, 32);
      advance();
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  __device__ void start() {
    s = 0;
    idx = -1;
    advance();
    taken = freed = 0;
    for (int i = 0; i < sw; ++i) fetch(slots + i * KS_TILE);
  }

  __device__ const double* take(int, int) {
    ks_wait_group(sw - 1 - (taken - freed));
    __syncwarp();
    return slots + (taken++ % sw) * KS_TILE;
  }

  __device__ void done() {
    __syncwarp();
    while (freed < taken) fetch(slots + (freed++ % sw) * KS_TILE);
  }
};

// U y = b in place, U the upper triangle of the factor (tiles (i, j), i <= j,
// taken as rows), rinv[i] = 1 / U_ii (1 past m): ks_backward's steps, its
// products read along U's rows instead of L's columns
template <class Src>
__device__ void k13_backward(Src& src, double* y, const double* rinv, int m, int warp, int wl) {
  const int T = ks_tiles(m);
  double acc = 0.0;
  for (int t = T - 1; t >= 0; --t) {
    const int r0 = t * KS_NB;
    if (warp == 0) {
      const bool fold = t > 0;
      const double* D = src.take(t, t) + wl * KS_LDT;
      const double* E = fold ? src.take(t - 1, t) + wl * KS_LDT : D;
      const int h = min(KS_NB, m - r0);
      const double r = rinv[r0 + wl];
      double b = y[r0 + wl] + acc, an = 0.0;
#pragma unroll
      for (int j = KS_NB - 1; j >= 0; --j) {
        if (j < h) {
          if (wl == j) b *= r;
          const double xj = __shfl_sync(FULL_MASK, b, j);
          if (wl < j) b = fma(-D[j], xj, b);
          if (fold) an = fma(-E[j], xj, an);
        }
      }
      if (wl < h) y[r0 + wl] = b;
      acc = an;
      src.done();
    } else if (t + 1 < T) {
      const double2* xs = reinterpret_cast<const double2*>(y + r0 + KS_NB);
      for (int i = t - warp; i >= 0; i -= KS_WARPS - 1) {
        const double* M = src.take(i, t + 1) + wl * KS_LDT;
        double a[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
        for (int p = 0; p < KS_NB / 2; ++p) {
          const double2 v = *reinterpret_cast<const double2*>(M + 2 * p), x = xs[p];
          a[(2 * p) & 3] = fma(v.x, x.x, a[(2 * p) & 3]);
          a[(2 * p + 1) & 3] = fma(v.y, x.y, a[(2 * p + 1) & 3]);
        }
        y[i * KS_NB + wl] -= (a[0] + a[1]) + (a[2] + a[3]);
        src.done();
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(KS_THREADS, 1)
lu_solve_f64_kernel(const double* __restrict__ LU, const int32_t* __restrict__ piv,
                    const double* __restrict__ b, double* __restrict__ x, int n) {
  extern __shared__ double2 k13_dyn[];
  const int T = ks_tiles(n), lane = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  double* slots = reinterpret_cast<double*>(k13_dyn);
  double* y = slots + (size_t)K11_RING * KS_TILE;   // [32 T], zeros past n
  double* ones = y + T * KS_NB;                     // [32 T], L's unit diagonal
  double* rinv = ones + T * KS_NB;                  // [32 T], ones past n
  int* sp = reinterpret_cast<int*>(rinv + T * KS_NB);   // [32 T], 0-based pivots
  const double* F = LU + (size_t)lane * n * n;
  K13Ring ring;
  ring.slots = slots + (warp == 0 ? 0 : K11_SLOTS0 + (warp - 1) * K11_SLOTS) * KS_TILE;
  ring.L = F;
  ring.m = n;
  ring.T = T;
  ring.sw = warp == 0 ? K11_SLOTS0 : K11_SLOTS;
  ring.warp = warp;
  ring.wl = wl;
  ring.pairs = (n & 1) == 0 && ((uintptr_t)LU & 15) == 0;
  ring.start();
  for (int i = tid; i < T * KS_NB; i += KS_THREADS) {
    y[i] = i < n ? b[(size_t)lane * n + i] : 0.0;
    ones[i] = 1.0;
    rinv[i] = i < n ? 1.0 / F[(size_t)i * (n + 1)] : 1.0;
    sp[i] = i < n ? piv[(size_t)lane * n + i] - 1 : i;
  }
  __syncthreads();
  if (tid == 0) {                       // LAPACK's interchanges, in order
    for (int k = 0; k < n; ++k) {
      const int p = sp[k];
      if (p != k && p >= 0 && p < n) {
        const double t = y[k];
        y[k] = y[p];
        y[p] = t;
      }
    }
  }
  __syncthreads();
  ks_forward(ring, y, ones, n, 2, warp, wl);
  k13_backward(ring, y, rinv, n, warp, wl);
  for (int i = tid; i < n; i += KS_THREADS) x[(size_t)lane * n + i] = y[i];
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// bytes of K13's dynamic shared memory at n, as kernels.lu_solve_f64_geometry
size_t k13_smem_bytes(int n) {
  const size_t rows = (size_t)KS_NB * ((n + KS_NB - 1) / KS_NB);
  return sizeof(double) * ((size_t)K11_RING * KS_TILE + 3 * rows) + sizeof(int) * rows;
}

// The launch floor: an empty kernel, timed by chip_smoke.py beside K1-K7.
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

// lds and smem come from kernels.lu_factor_geometry
int lu_factor_blocked(void* Ks, void* piv, int B, int N, int lds, int smem, void* stream) {
  return lu_blocked_launch<float, KB_NB>((float*)Ks, (int32_t*)piv, B, N, lds, smem,
                                         (cudaStream_t)stream);
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

// How many clusters of C CTAs with smem bytes of dynamic shared memory each
// the card runs at once, in the instance that the layout (N, R, res) takes;
// written to *max_clusters (int).
int ruiz_cluster_occupancy(int N, int R, int res, int C, int smem, void* max_clusters) {
  return k5_registers(N, R, res)
             ? k5_occupancy<K5_REG_ROWS, K5_REG_COLS, 1>(C, smem, (int*)max_clusters)
             : k5_occupancy<0, 1, 3>(C, smem, (int*)max_clusters);
}

// The layout (C CTAs a lane, R rows a CTA of which the first res are held in
// shared memory, `clusters` clusters in flight, smem bytes of dynamic shared
// memory) comes from kernels.ruiz_geometry; only the limits compiled into
// the kernel are checked here.
int ruiz_scale(const void* K, void* M, void* s, int B, int N, int C, int R, int res,
               int clusters, int smem, void* stream) {
  if (C < 1 || C > K5_MAX_CLUSTER || R < 1 || (long long)C * R < N || res < 0 || res > R
      || clusters < 1 || (size_t)smem < k5_smem(N, R, res)) {
    return (int)cudaErrorInvalidValue;
  }
  return k5_registers(N, R, res)
             ? k5_launch<K5_REG_ROWS, K5_REG_COLS, 1>(K, M, s, B, N, C, R, res, clusters, smem,
                                                      stream)
             : k5_launch<0, 1, 3>(K, M, s, B, N, C, R, res, clusters, smem, stream);
}

// as lu_factor_cluster_occupancy, for the QR cluster kernel
int qr_factor_cluster_occupancy(int C, int smem, void* max_clusters) {
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)qr_factor_cluster_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = k6_config(1, C, smem, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(
      (int*)max_clusters, (const void*)qr_factor_cluster_kernel, &cfg);
}

// The layout comes from kernels.qr_factor_geometry; only the limits
// compiled into the kernel are checked here.
int qr_factor_cluster(const void* M, void* qr, void* tau, int B, int N, int C, int cols,
                      int ld, int smem, void* stream) {
  if (N > 32 * K6_ROWS || ld > 32 * K6_ROWS || C < 1 || C > K2C_MAX_CLUSTER) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)qr_factor_cluster_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = k6_config(B, C, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, qr_factor_cluster_kernel, (const float*)M, (float*)qr,
                           (float*)tau, N, ld, cols);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Tw (B, KB_NB, KB_NB) and Ww (B, KB_NB, N): f32 scratch for each panel's T
// factor and V^T A22. lds and smem come from kernels.qr_factor_geometry, as
// for lu_factor_blocked. M is copied to qr first and left as it is.
int qr_factor_blocked(const void* M, void* qr, void* tau, void* Tw, void* Ww, int B, int N,
                      int lds, int smem, void* stream) {
  if (lds < N || lds % 2 == 0 || (size_t)smem < sizeof(float) * KB_NB * (size_t)lds) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute((const void*)qr_panel_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  float* a = (float*)qr;
  err = cudaMemcpyAsync(a, M, sizeof(float) * (size_t)B * N * N, cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return (int)err;
  for (int k0 = 0; k0 < N; k0 += KB_NB) {
    const int w = min(KB_NB, N - k0), nt = N - k0 - w;
    qr_panel_kernel<<<B, KB_THREADS, smem, st>>>(a, (float*)tau, (float*)Tw, N, k0, lds);
    if (nt > 0) {
      qr_w_kernel<<<dim3((nt + KB_NB - 1) / KB_NB, B), KB_UTHREADS, 0, st>>>(a, (float*)Ww, N, k0);
      const int tiles = ((N - k0 + KB_TR - 1) / KB_TR) * ((nt + KB_TC - 1) / KB_TC);
      qr_update_kernel<<<dim3(tiles, B), KB_UTHREADS, 0, st>>>(a, (const float*)Tw,
                                                                (const float*)Ww, N, k0);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// warps, the warps per lane, group, the tiles of a warp's staging slot, and
// smem, the dynamic shared memory, come from kernels.qr_solve_geometry (the
// pairs of kernels.QR_SOLVE_LAYOUTS); only that smem covers them at N is
// checked.
int qr_solve_batched(const void* qr, const void* tau, const void* v, void* x, int B, int N,
                     int warps, int group, int smem, void* stream) {
  switch (warps * 100 + group) {
    case 1608: return k7_launch<16, 8>(qr, tau, v, x, B, N, smem, stream);
    case 804: return k7_launch<8, 4>(qr, tau, v, x, B, N, smem, stream);
    case 801: return k7_launch<8, 1>(qr, tau, v, x, B, N, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// kernels.ADVANCE_FIELDS pointers, in order, as a host array
int advance_state(const void* const* ptrs, int B, int n, int n_eq, int n_ineq, double tau,
                  double kappa_mu, double mu_min, void* stream) {
  AdvancePtrs p;
  memcpy(&p, ptrs, sizeof p);
  advance_state_kernel<<<B, K4_THREADS, 0, (cudaStream_t)stream>>>(p, n, n_eq, n_ineq, tau,
                                                                   kappa_mu, mu_min);
  return (int)cudaGetLastError();
}

// K10's global variant, for the n that kernels.chol_factor_geometry gives it
int chol_factor_global(const void* M, void* L, void* ok, int B, int n, void* stream) {
  const size_t smem = sizeof(double) * (size_t)n * K10_LD;
  cudaError_t err = cudaFuncSetAttribute((const void*)chol_factor_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  chol_factor_kernel<<<B, K10_THREADS, smem, (cudaStream_t)stream>>>(
      (const double*)M, (double*)L, (uint8_t*)ok, n);
  return (int)cudaGetLastError();
}

// How many clusters of C CTAs with smem bytes of dynamic shared memory each
// the card runs at once; written to *max_clusters (int).
int chol_factor_cluster_occupancy(int C, int smem, void* max_clusters) {
  cudaError_t err = k10c_attributes(C, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = k10c_config(1, C, smem, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(
      (int*)max_clusters, (const void*)chol_factor_cluster_kernel, &cfg);
}

// The layout (C CTAs a lane, the leading dimension ld, the receive buffer
// at recv_off doubles, smem bytes of dynamic shared memory a rank) comes from
// kernels.chol_factor_geometry; only the limits compiled into the kernel
// are checked here.
int chol_factor_cluster(const void* M, void* L, void* ok, int B, int n, int C, int ld,
                        int recv_off, int smem, void* stream) {
  const int P = (n + K10C_NB - 1) / K10C_NB;
  if (C < 1 || C > K10C_MAX_CLUSTER || C > P || ld < K10C_NB || ld % 2 != 0
      || (size_t)smem < sizeof(double) * (size_t)recv_off) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = k10c_attributes(C, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = k10c_config(B, C, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, chol_factor_cluster_kernel, (const double*)M, (double*)L,
                           (uint8_t*)ok, n, ld, recv_off);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// smem, the dynamic shared memory, comes from kernels.chol_solve_geometry;
// only that it covers the ring and the vectors at n is checked.
int chol_solve_batched(const void* L, const void* b, void* x, int B, int n, int smem,
                       void* stream) {
  if (n < 1 || (size_t)smem < sizeof(double) * k11_smem_doubles(n)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute((const void*)chol_solve_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  chol_solve_kernel<<<B, KS_THREADS, smem, (cudaStream_t)stream>>>(
      (const double*)L, (const double*)b, (double*)x, n);
  return (int)cudaGetLastError();
}

// The layout (the leading dimensions ldf, ldr, lds and smem, the dynamic
// shared memory of a rank) comes from kernels.block_factor_geometry; only the
// limits compiled into the kernel are checked here. B clusters of n_k CTAs.
int block_factor(const void* Frame, const void* delta, const void* own_free, void* Li, void* Xc,
                 void* L_R, void* ok, int B, int n_k, int nx, int ni, int nb, int ldf, int ldr,
                 int lds, int smem, void* stream) {
  const int nloc = 2 * nx + ni + nb, nr = n_k * nx + nb, c = 2 * nx + nb;
  const long long need = 8LL * ((nloc * ldf > nr * ldr ? nloc * ldf : nr * ldr) + c * lds);
  if (n_k < 1 || n_k > KB8_MAX_CLUSTER || ni < 1 || nloc > 32 * KB8_CHUNKS
      || nr > 32 * KB8_CHUNKS || ldf < nloc || ldr < nr || lds < c || smem < need) {
    return (int)cudaErrorInvalidValue;
  }
  const void* fn = (const void*)block_factor_kernel;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = k2c_config(B, n_k, smem, stream, &attr);
  cfg.blockDim = dim3(KB8_THREADS);
  err = cudaLaunchKernelEx(&cfg, block_factor_kernel, (const double*)Frame, (const double*)delta,
                           (const double*)own_free, (double*)Li, (double*)Xc, (double*)L_R,
                           (uint8_t*)ok, n_k, nx, ni, nb, ldf, ldr, lds);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of n_k CTAs with smem bytes of dynamic shared memory
// each K9 runs at once; written to *max_clusters (int).
int block_solve_occupancy(int n_k, int smem, void* max_clusters) {
  cudaError_t err = kb9_attributes(n_k, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = kb9_config(1, n_k, smem, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters((int*)max_clusters,
                                             (const void*)block_solve_kernel, &cfg);
}

// The layout (ldx, Xc's leading dimension in shared memory, and smem, the
// dynamic shared memory of a rank) comes from kernels.block_solve_geometry;
// only the limits compiled into the kernel are checked here. B clusters of
// n_k CTAs.
int block_solve(const void* Li, const void* Xc, const void* L_R, const void* rhs,
                const void* chain_V, const void* intr_V, const void* border_V, void* x, int B,
                int n_k, int nx, int ni, int nb, int n, int ldx, int smem, void* stream) {
  if (n_k < 1 || n_k > KB8_MAX_CLUSTER || ni < 1 || ldx < 2 * nx + nb || ldx % 2 == 0
      || (size_t)smem < sizeof(double) * kb9_smem_doubles(n_k, nx, ni, nb, ldx)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = kb9_attributes(n_k, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = kb9_config(B, n_k, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, block_solve_kernel, (const double*)Li, (const double*)Xc,
                           (const double*)L_R, (const double*)rhs, (const long long*)chain_V,
                           (const long long*)intr_V, (const long long*)border_V, (double*)x, n_k,
                           nx, ni, nb, n, ldx);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// lds and smem come from kernels.lu_factor_f64_geometry
int lu_factor_f64(void* Ks, void* piv, int B, int N, int lds, int smem, void* stream) {
  return lu_blocked_launch<double, K12_NB>((double*)Ks, (int32_t*)piv, B, N, lds, smem,
                                           (cudaStream_t)stream);
}

// smem, the dynamic shared memory, comes from kernels.lu_solve_f64_geometry;
// only that it covers the ring and the vectors at n is checked.
int lu_solve_f64(const void* lu, const void* piv, const void* b, void* x, int B, int n, int smem,
                 void* stream) {
  if (n < 1 || (size_t)smem < k13_smem_bytes(n)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute((const void*)lu_solve_f64_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  lu_solve_f64_kernel<<<B, KS_THREADS, smem, (cudaStream_t)stream>>>(
      (const double*)lu, (const int32_t*)piv, (const double*)b, (double*)x, n);
  return (int)cudaGetLastError();
}

int noop(int blocks, void* stream) {
  noop_kernel<<<blocks, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
