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
        "repro_torch.kernels.ops, repro_torch.interop; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.api import AllocRequest, allocate
    from repro_torch.core.engine import p1_solve_batch
    from repro_torch.core.profiler import make_tenant_mix
    from repro_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    apps, caps, n0 = make_tenant_mix(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        allocate("crms", AllocRequest(apps, caps))
    with pytest.raises(RuntimeError, match="CUDA"):
        p1_solve_batch(apps, caps, n0[None, :], 1.4, 0.2)
    assert resolve_device("cpu") == torch.device("cpu")


def test_registry_lists_only_the_ported_policies():
    from repro_torch.api import list_policies

    assert list_policies() == ["crms", "crms_priority"]
