"""Card-only tests of the port: the hand-written CUDA ``crms_grid`` kernel
against its plain float32 version, and the main path's launches through it.

This file imports no JAX, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Without a CUDA device every test skips (the kernel has no CPU mode).
The plain version runs on the same device, so both sides use CUDA's expf/logf;
tolerances as chip_smoke.py states them: rtol 1e-5 on lanes with ρ <= 0.99,
1e-4 on all stable lanes, sentinel lanes > 1e6.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import AllocRequest, allocate
from repro_torch.core.profiler import make_tenant_mix
from repro_torch.kernels import crms_grid as port_kernel
from repro_torch.kernels import ops, ref

KW = dict(caps_cpu=30.0, power_span=150.0, alpha=1.4, beta=0.2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the crms_grid CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(M, B, seed, n_range=(3, 12)):
    rng = np.random.default_rng(seed)
    kappa = np.stack(
        [rng.uniform(20, 120, M), rng.uniform(0.8, 2.5, M), rng.uniform(0.2, 0.5, M)], axis=1
    )
    lam = rng.uniform(4, 12, M)
    xbar = rng.uniform(4, 6, M)
    n = rng.integers(*n_range, (B, M)).astype(float)
    c = rng.uniform(0.5, 3.0, (B, M))
    m = rng.uniform(0.25, 0.5, (B, M))
    return kappa, lam, xbar, n, c, m


def _rho(kappa, lam, xbar, n, c, m):
    d = kappa[:, 0] / (1.0 - np.exp(-kappa[:, 1] * c)) + np.exp(kappa[:, 2] / m)
    return lam / (n * 1000.0 / (xbar * d))


@pytest.mark.gpu
@pytest.mark.parametrize("reduce,M,B,n_range", [
    ("per_app", 64, 72, (3, 12)), ("sum", 64, 2000, (8, 20)),
    ("per_app", 7, 40, (3, 12)), ("sum", 4, 200, (3, 12)),
])
def test_cuda_kernel_matches_plain(cuda_device, reduce, M, B, n_range):
    arrays = _inputs(M, B, 5, n_range)
    before = port_kernel.launches
    out = ops.crms_grid(*(torch.as_tensor(a, device=cuda_device) for a in arrays),
                        reduce=reduce, **KW)
    torch.cuda.synchronize()
    assert port_kernel.launches == before + 1
    assert out.is_cuda and out.dtype == torch.float32
    # the plain version on the same device and inputs
    plain = ref.crms_grid_plain(*(torch.as_tensor(a, device=cuda_device) for a in arrays),
                                reduce=reduce, **KW).cpu().numpy()
    out = out.cpu().numpy()
    rho = _rho(*arrays) if reduce == "per_app" else np.max(_rho(*arrays), axis=1)
    stable = plain < 1e8
    assert stable.any() and not stable.all()  # both kinds of lane are checked
    tight = stable & (rho <= 0.99)
    np.testing.assert_allclose(out[tight], plain[tight], rtol=1e-5)
    np.testing.assert_allclose(out[stable], plain[stable], rtol=1e-4)
    assert np.all(out[~stable] > 1e6)


@pytest.mark.gpu
def test_main_path_launches_the_kernel(cuda_device):
    apps, caps, _ = make_tenant_mix(8)
    before = port_kernel.launches
    res = allocate("crms", AllocRequest(apps, caps, device=cuda_device.type))
    assert res.feasible and res.stable
    assert port_kernel.launches - before >= res.diagnostics.refine_iters > 0
