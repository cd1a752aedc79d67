"""The ``crms_grid`` kernel of the port: its plain float32 version against the
reference's Pallas kernel (interpret mode) and float64 oracle, at the shapes
of the reference's own kernel tests, in both output modes; the dispatch of
``ops.crms_grid``. The hand-written CUDA kernel itself is held against the
plain version on a CUDA device by tests/test_torch_gpu.py.

Tolerances. Plain float32 vs the interpreted Pallas kernel: rtol 1e-5 on
lanes with ρ <= 0.99 and 1e-4 on all stable lanes — both are float32 with
different exp/log implementations, and near ρ -> 1 the Erlang tail amplifies
last-place differences by ~1/(1-ρ). Against the float64 oracle: rtol 1e-4,
the reference's own bar. Unstable lanes carry the 1e9 sentinel (> 1e6).
"""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — switches JAX to float64, as the reference always runs
from repro.kernels import ops as ref_ops
from repro_torch.kernels import crms_grid as port_kernel
from repro_torch.kernels import ops, ref

KW = dict(caps_cpu=30.0, power_span=150.0, alpha=1.4, beta=0.2)
SHAPES = [(4, 200, 0), (7, 64, 0), (4, 96, 1), (7, 40, 1)]  # (M, B, seed)


def _inputs(M, B, seed):
    rng = np.random.default_rng(seed)
    kappa = np.stack(
        [rng.uniform(20, 120, M), rng.uniform(0.8, 2.5, M), rng.uniform(0.2, 0.5, M)], axis=1
    )
    lam = rng.uniform(4, 12, M)
    xbar = rng.uniform(4, 6, M)
    n = rng.integers(3, 12, (B, M)).astype(float)
    c = rng.uniform(0.5, 3.0, (B, M))
    m = rng.uniform(0.25, 0.5, (B, M))
    return kappa, lam, xbar, n, c, m


def _rho(kappa, lam, xbar, n, c, m):
    d = kappa[:, 0] / (1.0 - np.exp(-kappa[:, 1] * c)) + np.exp(kappa[:, 2] / m)
    return lam / (n * 1000.0 / (xbar * d))


def _port(arrays, reduce, backend="auto"):
    return ops.crms_grid(*(torch.as_tensor(a) for a in arrays), reduce=reduce,
                         backend=backend, **KW).numpy()


def _check_against_plain(out, plain, rho_lane):
    """Kernel-like output vs the plain version: stable lanes at the stated
    tolerances, sentinel lanes huge in both."""
    stable = plain < 1e8
    tight = stable & (rho_lane <= 0.99)
    np.testing.assert_allclose(out[tight], plain[tight], rtol=1e-5)
    np.testing.assert_allclose(out[stable], plain[stable], rtol=1e-4)
    assert np.all(out[~stable] > 1e6)


@pytest.mark.parametrize("M,B,seed", SHAPES)
def test_plain_per_app_matches_pallas_interpret(M, B, seed):
    arrays = _inputs(M, B, seed)
    plain = _port(arrays, "per_app")
    interp = np.asarray(ref_ops.crms_grid(*arrays, backend="interpret", reduce="per_app", **KW))
    assert plain.shape == (B, M) and plain.dtype == np.float32
    _check_against_plain(plain, interp, _rho(*arrays))


@pytest.mark.parametrize("M,B,seed", SHAPES)
def test_plain_sum_matches_pallas_interpret(M, B, seed):
    arrays = _inputs(M, B, seed)
    plain = _port(arrays, "sum")
    interp = np.asarray(ref_ops.crms_grid(*arrays, backend="interpret", reduce="sum", **KW))
    assert plain.shape == (B,)
    _check_against_plain(plain, interp, np.max(_rho(*arrays), axis=1))


@pytest.mark.parametrize("reduce", ["per_app", "sum"])
@pytest.mark.parametrize("M,B,seed", SHAPES)
def test_plain_matches_float64_oracle(M, B, seed, reduce):
    arrays = _inputs(M, B, seed)
    plain = _port(arrays, reduce)
    oracle = _port(arrays, reduce, backend="reference")
    assert oracle.dtype == np.float64
    stable = np.isfinite(oracle) & (oracle < 1e8)
    assert stable.sum() > 0
    np.testing.assert_allclose(plain[stable], oracle[stable], rtol=1e-4)
    assert np.all(plain[~stable] > 1e6)


@pytest.mark.parametrize("reduce", ["per_app", "sum"])
@pytest.mark.parametrize("M,B,seed", SHAPES)
def test_oracle_matches_reference_oracle(M, B, seed, reduce):
    arrays = _inputs(M, B, seed)
    port = _port(arrays, reduce, backend="reference")
    refo = np.asarray(ref_ops.crms_grid(*arrays, backend="reference", reduce=reduce, **KW))
    np.testing.assert_array_equal(np.isfinite(port), np.isfinite(refo))
    fin = np.isfinite(refo)
    np.testing.assert_allclose(port[fin], refo[fin], rtol=1e-12)


@pytest.mark.parametrize("M,B,seed", SHAPES)
def test_per_app_sums_to_sum(M, B, seed):
    arrays = _inputs(M, B, seed)
    np.testing.assert_allclose(_port(arrays, "sum"), _port(arrays, "per_app").sum(axis=1),
                               rtol=1e-5)


def test_dispatch_rejects_unknown_modes():
    arrays = [torch.as_tensor(a) for a in _inputs(4, 8, 0)]
    with pytest.raises(ValueError, match="reduce"):
        ops.crms_grid(*arrays, reduce="mean", **KW)
    with pytest.raises(ValueError, match="backend"):
        ops.crms_grid(*arrays, backend="pallas", **KW)
    with pytest.raises(ValueError, match="reduce"):
        ref.crms_grid_plain(*arrays, reduce="mean", **KW)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA launcher never silently runs elsewhere: CPU tensors take the
    plain version in ops.crms_grid, and the launcher itself raises."""
    arrays = [torch.as_tensor(a, dtype=torch.float32).contiguous() for a in _inputs(4, 8, 0)]
    with pytest.raises(ValueError, match="CUDA"):
        port_kernel.crms_grid_launch(*arrays, per_app=True, **KW)


# --- the Erlang head sum ends at the largest count ---------------------------
# The kernel ends its k-loop at its warp's largest count and the plain version
# at the grid's largest (ref.head_sum_steps); a step k >= n changes no lane,
# so both are bit for bit the fixed 127-step loop.
def _full_loop(monkeypatch, arrays, reduce):
    """The plain version with the head sum walking k = 1..127 whatever the
    counts, as the kernel did before it ended early."""
    with monkeypatch.context() as mp:
        mp.setattr(ref, "head_sum_steps", lambda n: ref.MAX_N - 1)
        return ref.crms_grid_plain(*arrays, reduce=reduce, **KW)


def _bits(t):
    """float32 bits, so that NaN lanes compare equal to NaN lanes."""
    return t.contiguous().view(torch.int32)


def _edge_lanes(M=9, B=24, seed=3):
    """Grid inputs with edge lanes: a NaN count, a non-integer count, counts
    of 127, 128 and 200 and an infinite one, each among counts of 3..11 in
    its row; log a of +inf (x̄ = inf), -inf (λ = 0) and NaN (κ₁ = NaN)."""
    kappa, lam, xbar, n, c, m = (torch.as_tensor(a, dtype=torch.float32)
                                 for a in _inputs(M, B, seed))
    n[0, 0], n[1, 1], n[2, 2] = float("nan"), 5.5, 127.0
    n[3, 3], n[4, 4], n[5, 5] = 128.0, 200.0, float("inf")
    n[6, 0] = 200.0  # one large count among small ones in a row
    xbar[6], lam[7], kappa[8, 0] = float("inf"), 0.0, float("nan")
    return kappa, lam, xbar, n, c, m


@pytest.mark.parametrize("reduce", ["per_app", "sum"])
@pytest.mark.parametrize("case", ["grid", "edges", "small_counts"])
def test_head_sum_ends_at_the_largest_count_bit_for_bit(monkeypatch, case, reduce):
    if case == "grid":
        arrays = tuple(torch.as_tensor(a, dtype=torch.float32) for a in _inputs(64, 72, 11))
    else:
        arrays = _edge_lanes()
        if case == "small_counts":  # the grid's largest count is 11: 10 steps
            n = arrays[3].clone()
            n[~torch.isfinite(n) | (n > 11)] = 11.0
            arrays = (*arrays[:3], n, *arrays[4:])
    early = ref.crms_grid_plain(*arrays, reduce=reduce, **KW)
    full = _full_loop(monkeypatch, arrays, reduce)
    assert torch.equal(_bits(early), _bits(full))
    if case == "edges" and reduce == "per_app":  # both kinds of lane are compared
        assert bool(torch.isnan(early[0, 0])) and bool(torch.isfinite(early).any())


def test_head_sum_steps():
    t = lambda *v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    assert ref.head_sum_steps(t(3, 11, 7)) == 10
    assert ref.head_sum_steps(t(5.5, 2)) == 5
    assert ref.head_sum_steps(t(127)) == 126
    assert ref.head_sum_steps(t(128, 3)) == ref.head_sum_steps(t(200)) == 127
    assert ref.head_sum_steps(t(float("inf"), 3)) == 127
    assert ref.head_sum_steps(t(float("nan"), 4)) == 3
    assert ref.head_sum_steps(t(float("nan"))) == ref.head_sum_steps(t(1, 0.5)) == 0
