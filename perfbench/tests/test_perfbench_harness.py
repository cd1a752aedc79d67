"""The harness on the CPU, on small cells added from new files only: the
result's keys, a cell found by name, no JAX, the faults it must catch, the
control's readings above the program's, and the command's refusals."""
import ast
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent
sys.path[:0] = [str(HERE / "tests")]

import tiny  # noqa: E402

SEED = 2**33 + 101


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make_bench(tmp_path_factory.mktemp("bench"))


def _run(bench, name, traced=False, seconds=3.0, seed=SEED, after=None):
    import time

    cell = tiny.cell(bench, name)
    import harness

    return harness.run(cell, seed, seconds, traced, device="cpu", t_start=time.perf_counter(),
                       device_info={"platform": "cpu", "kind": "cpu", "count": 1}, after=after)


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts
            and "out" not in p.parts}


def test_new_cells_come_from_new_files_alone(bench):
    before, after = _digests(HERE), _digests(bench / "perfbench")
    assert all(after[k] == v for k, v in before.items() if not k.startswith("tests/"))
    added = set(after) - set(before)
    assert added == {"configs/tiny-moe.json", "configs/tiny-mamba.json",
                     "traffic/tiny-prefill.json", "traffic/tiny-train.json",
                     "checks/tiny-moe.tiny-prefill.json", "checks/tiny-mamba.tiny-prefill.json",
                     "checks/tiny-mamba.tiny-train.json"}
    names = {w["name"] for w in json.loads((bench / "BENCHMARK.json").read_text())["workloads"]}
    assert {"tiny-moe.tiny-prefill", "tiny-mamba.tiny-train"} <= names


@pytest.mark.parametrize("name", [f"{c}.{m}" for c, m in tiny.CELLS])
def test_result_keys_and_correct(bench, name):
    res = _run(bench, name)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    kind = "train" if name.endswith("train") else "prefill"
    want = {"setup_s", f"{kind}_tokens_per_s"} | ({"prefill_p95_ms"} if kind == "prefill" else set())
    assert set(res["metrics"]) == want  # peak_mem_gib needs a card
    for m in res["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_traced_run_reads_per_layer_metrics(bench):
    res = _run(bench, "tiny-mamba.tiny-prefill", traced=True)
    assert set(res["device"]) >= {"busy_s", "window_s"}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU nothing runs on a device: only the FLOP count is read
    assert set(res["metrics"]) == {"mfu.prefill"}
    assert res["correct"] is True


FAULTS = [("tiny-moe.tiny-prefill", "half_batch"), ("tiny-moe.tiny-prefill", "token_altered"),
          ("tiny-mamba.tiny-prefill", "half_batch"), ("tiny-mamba.tiny-prefill", "token_altered"),
          ("tiny-mamba.tiny-train", "state_unchanged"), ("tiny-mamba.tiny-train", "half_batch"),
          ("tiny-mamba.tiny-train", "grad_altered")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_planted_faults_are_not_correct(bench, name, fault):
    tiny.cell(bench, name)
    import faults

    kind = "train" if name.endswith("train") else "prefill"
    with faults.for_entry(kind)[fault]():
        res = _run(bench, name)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("name", [f"{c}.{m}" for c, m in tiny.CELLS])
def test_control_reads_far_above_the_program(bench, name):
    """The float8 control, put in the program's place, reads at least three
    times what the program reads on one of the cell's numbers."""
    got = {}
    res = _run(bench, name, after=lambda ctx, state: got.update(ctx.entry.control(ctx, state)))
    ratios = {k: got[k] / max(v["value"], 1e-9) for k, v in res["checks"].items()}
    assert max(ratios.values()) >= 3.0, (ratios, got)


def _imports(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_imported(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}
    if "reference" in path.parts:
        assert "repro_torch" not in _imports(path)


def test_a_run_loads_no_jax_and_the_reference_no_port(bench):
    code = f"""
import sys, time
sys.path[:0] = [{str(HERE / 'tests')!r}]
import tiny
from pathlib import Path
cell = tiny.cell(Path({str(bench)!r}), "tiny-moe.tiny-prefill")
import harness
assert harness.forbidden_modules() == [], harness.forbidden_modules()
import reference.moe_decoder, reference.mamba2
assert not [m for m in sys.modules if m.split(".")[0] == "repro_torch"]
harness.run(cell, 7, 0.5, False, device="cpu", t_start=time.perf_counter())
assert "repro_torch" in sys.modules and harness.forbidden_modules() == []
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-2000:]


def test_forbidden_names_compared_whole():
    sys.path.insert(0, str(HERE))
    import harness

    sys.modules["repro_torch_like_name"] = sys
    try:
        assert "repro" not in harness.forbidden_modules()
    finally:
        del sys.modules["repro_torch_like_name"]


def _command(cwd: Path):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "mamba2-130m.prefill-backlog", "--seed", str(2**33 + 1), "--seconds",
                           "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=600)


def test_command_without_a_card_prints_nothing():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs a host without one")
    out = _command(REPO)
    assert out.returncode != 0 and out.stdout == ""


def test_command_without_the_program_fails(tmp_path):
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "perfbench", ignore=shutil.ignore_patterns("out", "__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
