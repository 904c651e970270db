"""The CUDA kernels of the PyTorch port (awebox_tpu_torch/parallel/kernels.py,
csrc/auglu.cu) against their plain PyTorch versions.

This file imports no JAX, so the card's machine, which has none, runs it:

    python -m pytest tests/test_torch_kernels.py -q -m cuda --noconftest

(``--noconftest``: tests/conftest.py configures JAX). The tests marked
``cuda`` skip without a card; the others check, on the CPU, what the kernels'
callers rely on there.
"""
import ctypes
import re

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
N_LADDER, LADDER = 7, 100.


def saddle_systems(lanes=5, n=24, m=17, seed=0):
    """Random saddle systems shaped like tests/test_batch_auglu.py's
    make_system: symmetric indefinite W0 with a barrier-like diagonal spread,
    rows of A over four decades, D of 1e-8 equality rows and small
    inequality rows. In the last lane variable 2 appears nowhere (zero row
    and column of W0, zero column of A), so K(delta) pins it only through
    delta: |dw_2| = |r1_2| / delta exceeds dw_cap until the delta ladder
    has raised delta, and that lane is retried alone."""
    rng = np.random.default_rng(seed)
    W0, A, D, r1, r2 = [], [], [], [], []
    for _ in range(lanes):
        Wh = rng.standard_normal((n, n))
        W0.append((Wh + Wh.T) / 2 + np.diag(10.0 ** rng.uniform(-2, 5, n)))
        A.append(rng.standard_normal((m, n)) * 10.0 ** rng.uniform(-2, 2, (m, 1)))
        D.append(np.concatenate([1e-8 * np.ones(m - 5), np.abs(rng.standard_normal(5)) * 1e-3]))
        r1.append(rng.standard_normal(n))
        r2.append(rng.standard_normal(m))
    W0, A, D, r1, r2 = (np.stack(x) for x in (W0, A, D, r1, r2))
    W0[-1, 2, :] = 0.
    W0[-1, :, 2] = 0.
    A[-1, :, 2] = 0.
    return [torch.as_tensor(x) for x in (W0, A, D, r1, r2)] + [torch.ones(n, dtype=torch.float64)]


def random_step_inputs(B=4, n=40, n_eq=20, n_ineq=8, seed=17, device='cpu'):
    """advance_state inputs: f64 states with w within 1e-9 of finite lower
    bounds, pinned and infinite bounds, random directions, a failed lane."""
    rng = np.random.default_rng(seed)
    lbw = np.where(rng.uniform(size=n) < 0.7, -1.0, -np.inf)
    ubw = np.where(rng.uniform(size=n) < 0.5, 1.0, np.inf)
    w = np.clip(rng.uniform(-0.9, 0.9, (B, n)), -0.9, 0.9)
    w = np.where(np.isfinite(lbw) & (rng.uniform(size=(B, n)) < 0.3), lbw + 1e-9, w)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64, device=device)
    state = dict(w=t(w), s=t(np.abs(rng.standard_normal((B, n_ineq))) + 1e-6),
                 y=t(rng.standard_normal((B, n_eq))),
                 lam=t(np.abs(rng.standard_normal((B, n_ineq))) * 1e-2),
                 zl=t(np.abs(rng.standard_normal((B, n)))), zu=t(np.abs(rng.standard_normal((B, n)))),
                 mu=t([1e-5, 1e-3, 1e-7, 1e-2][:B]))
    direction = tuple(t(rng.standard_normal(shape)) for shape in
                      ((B, n), (B, n_eq), (B, n_ineq), (B, n_ineq), (B, n), (B, n)))
    ok = torch.as_tensor(np.arange(B) != 1, device=device)
    err_d, err_k = t(np.abs(rng.standard_normal(B))), t(np.abs(rng.standard_normal(B)))
    return (state, direction, ok, err_d, err_k, t(lbw), t(ubw), 0.99, 0.4, 1e-8)


def test_kkt_assembly_plain_is_the_jax_formula():
    """K1's plain version computes awebox_tpu/parallel/batch.py:333-336,
    409-413 exactly: the same f32 operations in the same order (checked bit
    for bit against the formula in numpy f32)."""
    from awebox_tpu_torch.parallel import kernels
    rng = np.random.default_rng(2)
    B, n, m = 3, 9, 5
    W = rng.standard_normal((B, n, n)).astype(np.float32)
    W[0, 4, 4] = 0.          # pinned and zero: |diag| clipped to 1e-8
    A = rng.standard_normal((B, m, n)).astype(np.float32)
    Dr = np.abs(rng.standard_normal((B, m))).astype(np.float32) * 1e-3
    free = np.ones(n, np.float32)
    free[4] = 0.
    delta = np.array([1e-8, 1e-4, 1.0])
    Ks, kd = kernels.kkt_assemble_scaled(*(torch.as_tensor(a) for a in
                                           (W, A, Dr, free, delta)))
    for b in range(B):
        d32 = np.float32(delta[b])
        Wd = W[b] + d32 * np.diag(free)
        K = np.block([[Wd, A[b].T], [A[b], -np.diag(Dr[b])]])
        kdiag = np.concatenate([np.abs(np.diag(K)[:n]), Dr[b]])
        kd_ref = np.clip(np.float32(1.0) / np.sqrt(np.clip(kdiag, np.float32(1e-8), None)),
                         np.float32(0.), np.float32(1e4))
        np.testing.assert_array_equal(kd[b].numpy(), kd_ref)
        np.testing.assert_array_equal(Ks[b].numpy(), K * kd_ref[:, None] * kd_ref[None, :])
    assert abs(float(kd[0, 4]) - 1e4) <= 1.


def test_wrappers_take_the_plain_version_on_cpu_only():
    """On CPU tensors no kernel is built or launched and no count moves,
    through the whole direction solve and the step."""
    from awebox_tpu_torch.parallel import batch, kernels
    before = dict(kernels.LAUNCHES)
    sys_ = saddle_systems()
    n = sys_[0].shape[1]
    dw, dnu, ok = batch._auglu_solve(*sys_, n, 1e-8, 1e-8, N_LADDER, LADDER)
    assert bool(ok.all()) and bool(torch.isfinite(dw).all())
    kernels.advance_state(*random_step_inputs())
    assert kernels.LAUNCHES == before
    assert kernels._lib is None


def test_ctypes_signatures_match_the_cuda_entry_points():
    """The argument types bound in kernels.SIGNATURES are those of the
    extern "C" functions of csrc/auglu.cu (a mismatch would only show as a
    wrong launch on the card)."""
    from awebox_tpu_torch.parallel import kernels
    with open(kernels.SOURCE) as fh:
        src = fh.read()
    extern = src[src.index('extern "C" {'):]
    kinds = {'void*': ctypes.c_void_p, 'int': ctypes.c_int, 'double': ctypes.c_double}
    found = {}
    for name, params in re.findall(r'\nint (\w+)\(([^)]*)\)\s*\{', extern):
        types = []
        for p in params.split(','):
            words = p.replace('const', '').replace('*', ' * ').split()
            types.append(kinds['void*' if '*' in words else words[0]])
        found[name] = types
    assert found == kernels.SIGNATURES


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (the kernels have no CPU mode)')
    from awebox_tpu_torch.parallel import kernels
    kernels.library()
    return torch.device('cuda')


@pytest.mark.cuda
def test_assembly_and_step_kernels_match_plain_on_card(cuda):
    """K1 bit for bit (the same f32 operations, no FMA contraction) and K4 to
    1e-14 relative (the same f64 operations), each counted once."""
    from awebox_tpu_torch.parallel import kernels
    rng = np.random.default_rng(3)
    B, n, m = 3, 40, 25
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    args1 = (f32(rng.standard_normal((B, n, n))), f32(rng.standard_normal((B, m, n))),
             f32(np.abs(rng.standard_normal((B, m))) * 1e-3), f32(np.ones(n)),
             torch.tensor([1e-8, 1e-4, 1.0], dtype=torch.float64, device=cuda))
    before = dict(kernels.LAUNCHES)
    Ks, kd = kernels.kkt_assemble_scaled(*args1)
    Ks_p, kd_p = kernels.kkt_assemble_scaled_plain(*args1)
    args4 = random_step_inputs(device=cuda)
    out = kernels.advance_state(*args4)
    out_p = kernels.advance_state_plain(*args4)
    torch.cuda.synchronize()
    assert torch.equal(Ks, Ks_p) and torch.equal(kd, kd_p)
    for k in out_p:
        np.testing.assert_allclose(out[k].cpu().numpy(), out_p[k].cpu().numpy(),
                                   rtol=1e-14, atol=0, err_msg=k)
    assert kernels.LAUNCHES['kkt_assemble_scaled'] == before['kkt_assemble_scaled'] + 1
    assert kernels.LAUNCHES['advance_state'] == before['advance_state'] + 1


@pytest.mark.cuda
def test_direction_solve_on_card_matches_cpu(cuda):
    """K1-K3 inside the whole direction solve (two f64 refinement sweeps and
    the delta ladder) against the plain path on the CPU: ok lane by lane,
    and dw, dnu within 1e-6 of their max (the f32 factors differ in rounding;
    refinement brings both to the f64 solution of K(delta)). The ladder lane
    is retried on the card."""
    from awebox_tpu_torch.parallel import batch, kernels
    host = saddle_systems()
    n = host[0].shape[1]
    card = [t.to(cuda) for t in host]
    args = (n, 1e-8, 1e-8, N_LADDER, LADDER)
    before = kernels.LAUNCHES['lu_factor_batched']
    out_c = batch._auglu_solve(*card, *args)
    out_h = batch._auglu_solve(*host, *args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['lu_factor_batched'] - before >= 2   # the ladder ran
    np.testing.assert_array_equal(out_c[2].cpu().numpy(), out_h[2].numpy())
    for k in range(2):
        ref = out_h[k].numpy()
        np.testing.assert_allclose(out_c[k].cpu().numpy(), ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())
