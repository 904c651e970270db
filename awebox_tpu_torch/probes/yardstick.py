"""The yardsticks a kernel is held against, shared by chip_smoke.py and the
phase probes so that both report the same numbers: the least time the card
could take for a piece of work, for K8-K11 (block_factor, block_solve,
chol_factor_batched, chol_solve_batched) the work each function must do,
for K8 and K9 the library composition of the same function, and the gaps
of a factor to a reference.
"""
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_OPS_PER_S = 67e12      # H100 SXM at 700 W: f32 on the CUDA cores, f64 on the tensor cores


def bound(nbytes, ops=0):
    """The least time the card could take for the work, in ms, and what
    sets it: the larger of the bytes over HBM3's 3.35 TB/s and the
    operations over their peak (H100 SXM data sheet, at 700 W), 67 TFLOP/s
    for both types here: f32 on the CUDA cores, and f64 on the tensor
    cores, the fastest the card does f64 (K8's and K10's updates run there;
    the other f64 kernels run on the CUDA cores' 34)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def block_factor_bound(lay, B):
    """K8's bound at B lanes of layout lay: the lower triangle of each
    (symmetric) frame, delta and own_free read once; Li, Xc and L_R (with
    their zeros, which the contract writes) and ok written once; the
    operations of the interiors' Cholesky, the coupling solves, the Schur
    products and R's Cholesky."""
    n_k, nx, ni, nb, nloc = lay
    c, nr = lay.c, lay.nr
    nbytes = 8 * (B * n_k * nloc * (nloc + 1) // 2 + B + n_k * nloc
                  + B * (n_k * ni * ni + n_k * ni * c + nr * nr)) + B
    ops = B * (n_k * (ni ** 3 / 3 + ni * ni * c + ni * c * c) + nr ** 3 / 3)
    return bound(nbytes, ops)


def chol_factor_bound(n, B):
    """K10's bound at B lanes of n x n: the lower triangle of each (symmetric)
    M read once, L (with its zeros, which the contract writes) and ok
    written once; n^3 / 3 operations a lane, at the f64 tensor-core peak
    (the cluster variant's updates run there)."""
    nbytes = 8 * B * (n * (n + 1) // 2 + n * n) + B
    return bound(nbytes, B * n ** 3 / 3)


def block_solve_bound(lay, B):
    """K9's bound at B lanes of layout lay: the lower triangles of Li and L_R,
    Xc, the right-hand sides and the index maps read once, x written once;
    the operations of the four triangular solves and the two coupling
    products."""
    n_k, nx, ni, nb, nloc = lay
    c, nr = lay.c, lay.nr
    n = n_k * (nx + ni) + nb
    nbytes = 8 * (B * (n_k * ni * (ni + 1) // 2 + nr * (nr + 1) // 2 + n_k * ni * c + 2 * n) + n)
    ops = B * (2 * n_k * ni * ni + 4 * n_k * ni * c + 2 * nr * nr)
    return bound(nbytes, ops)


def chol_solve_bound(n, B):
    """K11's bound at B lanes of n x n: the lower triangle of L and b read
    once, x written once; the 2 n^2 operations of the two substitutions."""
    return bound(8 * B * (n * (n + 1) // 2 + 2 * n), 2 * B * n * n)


def block_solve_library(Li, Xc, L_R, rhs, lay, intr_V):
    """A call of PyTorch's composition of K9's function on these inputs, as
    chip_smoke.py times it: the interior solve_triangular, the coupling
    product, the reduced pair, the coupling update and the transposed
    interior solve (four solve_triangular and two products)."""
    st = torch.linalg.solve_triangular
    r_int = rhs[:, intr_V][..., None]
    r_red = rhs[:, :lay.nr, None].contiguous()
    x_cpl = rhs[:, None, :lay.c, None].expand(-1, lay.n_k, -1, -1).contiguous()

    def call():
        t = st(Li, r_int, upper=False)
        u = Xc.transpose(-1, -2) @ t
        xr = st(L_R.transpose(-1, -2), st(L_R, r_red, upper=False), upper=True)
        return st(Li.transpose(-1, -2), t - Xc @ x_cpl, upper=True), u, xr
    return call


def block_factor_library(Frame, delta, own_free, lay, L_R):
    """A call of PyTorch's composition of K8's function on these inputs:
    cholesky_ex of the damped interiors, solve_triangular for the coupling
    columns, the Schur product a frame, and cholesky_ex of R = L_R L_R^T."""
    oi, og = 2 * lay.nx, 2 * lay.nx + lay.ni
    Fr = Frame.clone()
    Fr.diagonal(dim1=-2, dim2=-1).add_(delta[:, None, None] * own_free)
    Mii = Fr[:, :, oi:og, oi:og].contiguous()
    Mic = torch.cat([Fr[:, :, oi:og, :oi], Fr[:, :, oi:og, og:]], dim=-1).contiguous()
    Rc = (L_R @ L_R.transpose(1, 2)).contiguous()

    def call():
        L = torch.linalg.cholesky_ex(Mii)[0]
        X = torch.linalg.solve_triangular(L, Mic, upper=False)
        return X.transpose(-1, -2) @ X, torch.linalg.cholesky_ex(Rc)[0]
    return call


def block_factor_gaps(fac, ref, lanes=slice(None)):
    """max |Li - Li_ref|, |Xc - Xc_ref| and |R - R_ref| (R = L_R L_R^T) on
    the given lanes, each over the reference's max."""
    out = [float((fac[k][lanes] - ref[k][lanes]).abs().max() / ref[k][lanes].abs().max())
           for k in range(2)]
    R = fac[2][lanes] @ fac[2][lanes].transpose(1, 2)
    R_ref = ref[2][lanes] @ ref[2][lanes].transpose(1, 2)
    return out + [float((R - R_ref).abs().max() / R_ref.abs().max())]
