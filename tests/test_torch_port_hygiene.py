"""The port stands alone: no module of ``repro_torch`` (and not
``chip_smoke.py``) imports JAX or the ``repro`` package, importing the port
leaves JAX unloaded, no source of the port calls a library attention kernel,
and its entry points default to the CUDA device and raise without one
instead of falling back to the CPU."""
import ast
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "examples_torch").glob("*.py"))
              + sorted((ROOT / "benchmarks_torch").glob("*.py")))


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


PORT_SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
    p for p in (ROOT / "src" / "repro_torch").rglob("*.cu*") if p.suffix in (".cu", ".cuh"))
# What the port may not call: torch's fused attention entry points (also when
# reached by name through getattr) and the attention packages. torch.matmul
# stays allowed: the model's projections are plain GEMMs, not attention.
LIBRARY_ATTENTION_NAMES = {
    "scaled_dot_product_attention", "_scaled_dot_product_flash_attention",
    "_scaled_dot_product_efficient_attention", "_scaled_dot_product_cudnn_attention",
    "_flash_attention_forward", "_efficient_attention_forward",
    "multi_head_attention_forward", "MultiheadAttention",
}
LIBRARY_ATTENTION_MODULES = {"flash_attn", "xformers"}
# In the CUDA sources: cuBLAS / cuDNN headers or symbols, and CUTLASS's
# device-level GEMM (CuTe/CUTLASS building blocks inside a kernel are allowed).
LIBRARY_HEADERS = re.compile(r"^\s*#\s*include\s*[<\"](cublas|cudnn|cutlass/gemm/device)", re.M)
LIBRARY_SYMBOLS = re.compile(r"\b(cublas\w*|cudnn\w*|CUBLAS\w*|CUDNN\w*|GemmUniversal\w*)\b")


def _library_attention_calls(path):
    """Names of library attention kernels that a Python source reaches: as an
    attribute or name it uses, as a string (getattr), or as a module it
    imports."""
    found = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Attribute):
            found.add(node.attr)
        elif isinstance(node, ast.Name):
            found.add(node.id)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            found.add(node.value)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            found |= {alias.name for alias in node.names}
    return (found & LIBRARY_ATTENTION_NAMES) | (_imported_roots(path) & LIBRARY_ATTENTION_MODULES)


def _library_kernel_uses(path):
    """cuBLAS/cuDNN/CUTLASS-GEMM headers and symbols of a CUDA source, its
    comments left out."""
    code = re.sub(r"//[^\n]*|/\*.*?\*/", "", path.read_text(), flags=re.S)
    return set(LIBRARY_HEADERS.findall(code)) | set(LIBRARY_SYMBOLS.findall(code))


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_library_attention_or_gemm_kernels(path):
    uses = _library_attention_calls if path.suffix == ".py" else _library_kernel_uses
    assert not uses(path)


def test_library_call_checks_see_calls_not_prose(tmp_path):
    """The checks above find a call however it is spelled, and not a comment
    or docstring that names the library."""
    calls = {
        "a.py": "import torch.nn.functional as F\nF.scaled_dot_product_attention(q, k, v)\n",
        "b.py": "import torch\ngetattr(torch.nn.functional, 'scaled_dot_product_attention')\n",
        "c.py": "from torch.nn.functional import scaled_dot_product_attention as sdpa\n",
        "d.py": "from flash_attn import flash_attn_func\n",
        "e.cu": "#include <cublas_v2.h>\nint f() { return 0; }\n",
        "f.cu": "void g(cublasHandle_t h) { cublasSgemm(h); }\n",
        "g.cu": "#include <cutlass/gemm/device/gemm.h>\n",
    }
    prose = {
        "h.py": '"""Not scaled_dot_product_attention, nor cuBLAS."""\nx = torch.matmul(a, b)\n',
        "i.cu": "// no cuBLAS, cuDNN or CUTLASS here\n/* cublasSgemm */ int f();\n",
    }
    for name, text in {**calls, **prose}.items():
        (tmp_path / name).write_text(text)
    check = {".py": _library_attention_calls, ".cu": _library_kernel_uses}
    for name in calls:
        assert check[pathlib.Path(name).suffix](tmp_path / name), name
    for name in prose:
        assert not check[pathlib.Path(name).suffix](tmp_path / name), name


def test_kernel_libraries_are_named_by_their_headers_too(tmp_path):
    """Every local header a kernel source includes lies beside it as a .cuh
    file, and the library's hash changes when such a header does, so an
    edited header never loads a stale library."""
    from repro_torch.kernels.build import CSRC, source_digest

    for source in sorted(CSRC.glob("*.cu")):
        for name in re.findall(r'^\s*#\s*include\s*"([^"]+)"', source.read_text(), re.M):
            assert (CSRC / name).suffix == ".cuh" and (CSRC / name).parent == CSRC, (source, name)
            assert (CSRC / name).exists(), (source, name)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    before = source_digest(tmp_path / "k.cu")
    assert source_digest(tmp_path / "k.cu") == before
    (tmp_path / "h.cuh").write_text("// two\n")
    assert source_digest(tmp_path / "k.cu") != before


def test_importing_the_port_leaves_jax_unloaded():
    code = (
        "import sys, repro_torch.api, repro_torch.api.policies, repro_torch.core.crms, "
        "repro_torch.kernels.ops, repro_torch.interop, repro_torch.configs, "
        "repro_torch.models.model, repro_torch.serve.engine, repro_torch.serve.step, "
        "repro_torch.kernels.flash_attention, repro_torch.kernels.ssd, "
        "repro_torch.models.mamba, repro_torch.launch.serve, repro_torch.launch.train, "
        "repro_torch.train.loop, repro_torch.train.step, repro_torch.train.optimizer, "
        "repro_torch.train.checkpoint, repro_torch.data.pipeline, repro_torch.core.des, "
        "repro_torch.core.des_vector, repro_torch.core.arrivals, repro_torch.core.failures, "
        "repro_torch.core.lifecycle, repro_torch.api.scenario, repro_torch.api.quasidynamic, "
        "repro_torch.core.baselines, repro_torch.core.placement, repro_torch.core.fleet, "
        "repro_torch.serve.fleet, repro_torch.launch.mesh, repro_torch.launch.specs, "
        "repro_torch.launch.traffic, repro_torch.sharding.rules; "
        "repro_torch.configs.registry(); "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


MESH_MODULES = ("launch/mesh.py", "launch/specs.py", "launch/traffic.py",
                "sharding/rules.py", "sharding/__init__.py", "launch/train.py",
                "train/step.py", "train/optimizer.py", "train/checkpoint.py", "train/loop.py")
# The sharded train step's code: a failure on a rank fails the run, so none of
# it catches an exception (no fallback to one device or to the plain route).
MESH_TRAIN_CODE = ("models/layers.py", "models/model.py", "models/moe.py", "models/mamba.py",
                   "train/step.py", "train/optimizer.py", "train/checkpoint.py",
                   "train/loop.py", "launch/train.py")
# The one handler allowed: the one-device restart of run_with_recovery, which
# returns before its try on a mesh (tests/test_torch_mesh_train_loop.py
# holds a failure on the mesh to fail the run on every rank).
ALLOWED_HANDLERS = {"train/loop.py": {"run_with_recovery"}}


def test_mesh_modules_are_in_the_import_check():
    checked = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in PORT_FILES
               if (ROOT / "src" / "repro_torch") in p.parents}
    assert set(MESH_MODULES) <= checked


@pytest.mark.parametrize("rel", MESH_TRAIN_CODE)
def test_mesh_training_code_catches_nothing(rel):
    tree = ast.parse((ROOT / "src" / "repro_torch" / rel).read_text())
    allowed = ALLOWED_HANDLERS.get(rel, set())
    handlers = [node.lineno for fn in ast.walk(tree)
                if isinstance(fn, ast.FunctionDef) and fn.name not in allowed
                for node in ast.walk(fn) if isinstance(node, ast.ExceptHandler)]
    handlers += [node.lineno for node in tree.body if isinstance(node, ast.Try)]
    assert not handlers, f"{rel}: except clauses at lines {handlers}"


def test_production_mesh_launcher_defaults_to_cuda_and_needs_its_ranks():
    """launch.train --production-mesh builds the CUDA production mesh: in a
    process without its 256 ranks it raises the mesh's RuntimeError."""
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="mesh \\(16, 16\\) needs 256 ranks"):
        train.main(["--arch", "mamba2-130m", "--production-mesh"])


def test_mesh_entry_points_default_to_cuda(monkeypatch):
    """The meshes are CUDA meshes unless told otherwise and refuse a process
    group with fewer ranks than they need; a runtime on a CUDA mesh raises
    without a card (the same checks inside a group of ranks:
    tests/test_torch_mesh.py)."""
    import inspect

    from repro_torch.launch import mesh as M
    from repro_torch.models.layers import Runtime

    for fn in (M.make_production_mesh, M.make_smoke_mesh, M.make_mesh):
        assert inspect.signature(fn).parameters["device_type"].default == "cuda"
    with pytest.raises(RuntimeError, match="needs 4 ranks but only 0"):
        M.make_smoke_mesh()
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        M.make_production_mesh(multi_pod=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    class CudaMesh:
        device_type = "cuda"

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Runtime(mesh=CudaMesh())


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
    from repro_torch.train.loop import Trainer, TrainerConfig

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, TrainerConfig())

    # the simulation: the vector engine and the rollouts run on the card by
    # default; the event engine is host code and takes no device
    from repro_torch.core import des
    from repro_torch.core.des_vector import rollout_candidates
    from repro_torch.core.problem import Allocation

    with pytest.raises(RuntimeError, match="device='cpu'"):
        des.FleetSimulator(engine="vector")
    mu, n = np.array([[2.0, 3.0]]), np.array([[3, 2]])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rollout_candidates(["a", "b"], [4.0, 3.0], mu, n, 10.0)
    alloc = Allocation(n=n0, r_cpu=np.full(4, 1.5), r_mem=np.array([a.r_max for a in apps]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        des.simulate_allocation(apps, alloc, horizon_s=20.0, warmup_s=2.0, engine="vector")
    assert des.FleetSimulator(engine="vector", device="cpu").device == torch.device("cpu")
    assert np.isfinite(rollout_candidates(["a", "b"], [4.0, 3.0], mu, n, 10.0,
                                          device="cpu").mean_s).all()
    on_cpu = des.simulate_allocation(apps, alloc, horizon_s=20.0, warmup_s=2.0,
                                     engine="vector", device="cpu")
    on_host = des.simulate_allocation(apps, alloc, horizon_s=20.0, warmup_s=2.0)
    assert [s.n_completed for s in on_cpu] == [s.n_completed for s in on_host]
    assert type(des.FleetSimulator()) is des.FleetSimulator

    # the policies on the simulation and the scenario runner: every solve and
    # the vector engine's replay run on the card by default
    from repro_torch.api import Scenario, ScenarioRunner, get_policy

    for name in ("robust_crms", "robust_crms_p95", "crms_lifecycle", "robust_crms_lifecycle",
                 "crms_shed", "crms_failover", "predictive_crms"):
        policy = get_policy(name)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            policy.allocate(AllocRequest(apps, caps, extra={"robust": 1.5}))
        if hasattr(policy, "reset"):
            policy.reset()
    scenario = Scenario(name="s", apps=tuple(apps), caps=caps, n_epochs=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ScenarioRunner(scenario, ["crms"], backend="des", des_engine="vector", device=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ScenarioRunner(scenario, ["crms"], backend="des")
    runner = ScenarioRunner(scenario, ["crms"], backend="des", des_engine="vector",
                            device="cpu")
    assert runner.device == "cpu"

    # the search baselines and the fleet placement layer: their scoring, SP1
    # demands and row solves run on the card by default
    from repro_torch.api import FleetScenario, FleetScenarioRunner
    from repro_torch.core.placement import FleetPlanner, make_fleet

    for name, extra in (("random_search", {"n_samples": 10}), ("drf", {}),
                        ("crms_fleet", {"node_caps": [(30.0, 10.0), (30.0, 10.0)]})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            allocate(name, AllocRequest(apps, caps, extra=extra))
    fleet_apps, node_caps = make_fleet(2, 3, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetPlanner(fleet_apps, node_caps)
    fleet = FleetScenario.from_fleet("f", 2, 3, n_epochs=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetScenarioRunner(fleet)
    assert FleetPlanner(fleet_apps, node_caps, device="cpu").device == torch.device("cpu")
    assert FleetScenarioRunner(fleet, device="cpu").device == "cpu"


def test_fleet_binding_defaults_to_cuda(monkeypatch):
    """FleetManager, the fleet allocator, ``launch.serve --plan`` and the
    fleet_tpu benchmark fit and solve on the card by default and raise
    without one; ``device="cpu"`` reaches the fit and every request."""
    from repro_torch.core import fleet
    from repro_torch.launch import serve
    from repro_torch.serve.fleet import FleetManager

    workloads = fleet.default_workloads()[:2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetManager(workloads, n_chips=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fleet.fleet_allocator(workloads, n_chips=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--plan"])
    from torch_scripts import chip_smoke

    bench = chip_smoke.load_script("benchmarks_torch/fleet_tpu.py")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.run([])
    fm = FleetManager(workloads, n_chips=64, device="cpu")
    seen, crms = [], fm.allocator.policy

    class Spy:
        name = crms.name

        def allocate(self, request):
            seen.append(request.device)
            return crms.allocate(request)

    fm.allocator.policy = Spy()
    alloc, groups = fm.plan()
    assert seen == ["cpu"] and len(groups) == int(np.sum(alloc.n))


def test_registry_lists_only_the_ported_policies():
    """Every policy of the reference is ported: the two registries list the
    same names."""
    from repro.api import list_policies as ref_list_policies
    from repro_torch.api import list_policies

    assert list_policies() == sorted(ref_list_policies())
