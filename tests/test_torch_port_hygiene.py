"""The port stands alone: no module of ``repro_torch`` (and not
``chip_smoke.py``) imports JAX or the ``repro`` package, importing the port
leaves JAX unloaded, and its entry points default to the CUDA device and
raise without one instead of falling back to the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert path.exists()
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}


def test_importing_the_port_leaves_jax_unloaded():
    code = (
        "import sys, repro_torch.api, repro_torch.api.policies, repro_torch.core.crms, "
        "repro_torch.kernels.ops, repro_torch.interop, repro_torch.configs, "
        "repro_torch.models.model, repro_torch.serve.engine, repro_torch.serve.step, "
        "repro_torch.kernels.flash_attention, repro_torch.kernels.ssd, "
        "repro_torch.models.mamba, repro_torch.launch.serve; "
        "repro_torch.configs.registry(); "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_default_to_cuda(monkeypatch):
    import numpy as np

    from repro_torch.api import AllocRequest, allocate
    from repro_torch.configs import get_config
    from repro_torch.core import perf_model
    from repro_torch.core.engine import p1_solve_batch
    from repro_torch.core.profiler import make_tenant_mix
    from repro_torch.device import resolve_device
    from repro_torch.models.layers import Runtime
    from repro_torch.models.model import LM, init_params
    from repro_torch.serve.engine import Engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    apps, caps, n0 = make_tenant_mix(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        allocate("crms", AllocRequest(apps, caps))
    with pytest.raises(RuntimeError, match="CUDA"):
        p1_solve_batch(apps, caps, n0[None, :], 1.4, 0.2)
    assert resolve_device("cpu") == torch.device("cpu")

    fit = perf_model.FitResult(family="eq1", params=np.array([60.0, 1.2, 0.4]), rmse=0.0,
                               mse=0.0, r2=1.0, adj_r2=1.0, residuals=np.zeros(1),
                               converged=True)
    cpu, mem = np.array([0.5, 1.0, 2.5]), np.array([0.25, 0.4, 0.5])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit.predict(cpu, mem)
    import repro.core.perf_model as ref_perf_model  # the reference, for the same fit

    ref_fit = ref_perf_model.FitResult(**{f: getattr(fit, f) for f in (
        "family", "params", "rmse", "mse", "r2", "adj_r2", "residuals", "converged")})
    np.testing.assert_allclose(fit.predict(cpu, mem, device="cpu"), ref_fit.predict(cpu, mem),
                               rtol=1e-12)

    cfg = get_config("gemma-2b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM(get_config("mamba2-130m").reduced())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Runtime()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, LM(cfg, "cpu"))


def test_registry_lists_only_the_ported_policies():
    from repro_torch.api import list_policies

    assert list_policies() == ["crms", "crms_priority"]
