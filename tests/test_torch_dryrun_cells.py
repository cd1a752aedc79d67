"""The port's dry-run cells on the CPU (``--device cpu``: fake CPU tensors on
a fake process group), each traced in a subprocess so that no fake group
outlives it in a test worker:

* gemma-2b decode_32k and mamba2-130m prefill_32k on single_pod at full
  width: ``status: ok``, every key of the reference's row
  (``repro/launch/dryrun.py::run_cell``), and the values the reference's own
  functions give for model_flops, traffic_bytes_per_device, params_bytes,
  kv_bytes_per_seq, chips, global_batch, seq and kind; the flash and SSD
  operators counted in the traces;
* ``core.fleet.workloads_from_roofline`` reads the port's decode row as the
  reference's reads it;
* the reduced gemma-2b train step on a (2, 2) fake mesh issues the same
  collectives, calls and result bytes kind by kind, as the same step on
  four gloo ranks (``launch.mesh.spawn``)."""
import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

import repro.core  # noqa: F401  (x64 as in the reference's own test runs)
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.core import fleet as ref_fleet
from repro.launch.traffic import min_traffic_bytes as ref_traffic
from repro_torch.configs import get_config
from repro_torch.core import fleet
from repro_torch.launch.mesh import spawn

from torch_scripts import DRYRUN_STEP, dryrun_gloo_collectives

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = (("gemma-2b", "decode_32k"), ("mamba2-130m", "prefill_32k"))
SINGLE_POD = {"data": 16, "model": 16}


def _run(code, timeout=240):
    """``code`` in a fresh interpreter (the port on its path, one torch
    thread): its last line of output as JSON."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep + str(ROOT / "tests"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], env=env,
                          capture_output=True, text=True, timeout=timeout, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def rows():
    return {cell: _run(f"""
        import json, torch
        torch.set_num_threads(1)
        from repro_torch.launch.dryrun import run_cell
        row = run_cell({cell[0]!r}, {cell[1]!r}, "single_pod", device="cpu", verbose=False)
        print(json.dumps(row))
        """) for cell in CELLS}


def reference_row_keys() -> set:
    """The keys of a row of the reference's ``run_cell``: its first three,
    and every keyword of its ``row.update(...)``."""
    tree = ast.parse((ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text())
    run_cell = next(n for n in ast.walk(tree)
                    if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    keys = {"arch", "shape", "mesh"}
    for node in ast.walk(run_cell):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "update":
            keys |= {k.arg for k in node.keywords}
    return keys


def reference_values(arch, shape):
    """The row's values that the reference's own functions give for the cell
    on single_pod (its 14e9-byte decode layout rule included)."""
    cfg = ref_config(arch)
    seq, gbs, kind = REF_SHAPES[shape]
    chips = 256
    model_only = kind == "decode" and not cfg.pure_dp and (
        2 * cfg.total_params() / (1 if cfg.pure_dp else 16)
        + cfg.kv_bytes_per_seq(seq) * gbs / chips) < 14e9
    n = cfg.active_params()
    mf = {"train": 6.0 * n * seq * gbs, "prefill": 2.0 * n * seq * gbs,
          "decode": 2.0 * n * gbs}[kind]
    return dict(model_flops=mf, chips=chips, global_batch=gbs, seq=seq, kind=kind,
                traffic_bytes_per_device=ref_traffic(cfg, shape, SINGLE_POD, serve_bytes=2.0,
                                                     decode_model_only=model_only),
                params_bytes=2.0 * cfg.total_params() if kind != "train"
                else 4.0 * cfg.total_params(),
                kv_bytes_per_seq=cfg.kv_bytes_per_seq(seq))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_row_matches_the_reference(rows, arch, shape):
    row = rows[(arch, shape)]
    assert row["status"] == "ok", row.get("traceback")
    assert reference_row_keys() <= set(row), reference_row_keys() - set(row)
    for key, want in reference_values(arch, shape).items():
        assert row[key] == want, (key, row[key], want)
    assert row["compile_s"] == 0.0 and row["lower_s"] >= 0.0
    assert row["hlo_flops_per_device"] > 0 and row["hlo_bytes_per_device"] > 0
    assert row["hlo_flops_total"] == row["hlo_flops_per_device"] * 256
    assert row["collective_bytes_total"] == row["collective_bytes_per_device"] * 256
    assert row["collective_bytes_per_device"] == sum(row["collective_breakdown"].values())
    assert row["dominant"] in ("compute", "memory", "collective")
    assert row["memory_term_s"] == row["traffic_bytes_per_device"] / 3.35e12
    ma = row["memory_analysis"]
    assert set(ma) == {"temp_size_in_bytes", "argument_size_in_bytes", "output_size_in_bytes",
                       "generated_code_size_in_bytes"}
    assert ma["argument_size_in_bytes"] > 0 and ma["temp_size_in_bytes"] > 0
    # one repeat of the model's one stage; every layer traced once
    [body] = row["stage_bodies"]
    assert body["stage"] == "stage0" and body["repeat"] == ref_config(arch).n_layers
    assert 0 < body["repeat"] * body["flops"] <= row["hlo_flops_per_device"]


def test_traces_reach_the_kernel_operators(rows):
    """mamba2-130m's prefill reaches the SSD operator once a layer; gemma-2b's
    decode step attends over the cache in plain torch (flash-decode over the
    T-sharded cache) and reaches no flash operator, as on the card."""
    assert rows[("mamba2-130m", "prefill_32k")]["kernel_ops"] == {"flash_fwd": 0,
                                                                  "ssd_chunk_fwd": 24}
    assert rows[("gemma-2b", "decode_32k")]["kernel_ops"] == {"flash_fwd": 0,
                                                             "ssd_chunk_fwd": 0}


def test_workloads_from_roofline_reads_the_port_rows(rows, tmp_path):
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(list(rows.values())))
    got = [dataclasses.asdict(w) for w in fleet.workloads_from_roofline(path)]
    want = [dataclasses.asdict(w) for w in ref_fleet.workloads_from_roofline(str(path))]
    assert got == want and [w["name"] for w in got] == ["gemma-2b"]
    assert got[0]["flops_per_tok"] > 0 and got[0]["params_bytes"] > 0


def test_fake_mesh_step_issues_the_collectives_of_four_gloo_ranks():
    """The reduced gemma-2b train step (its four microbatches, float32, AdamW) on a
    (2, 2) fake mesh: the same c10d calls and result bytes, name by name, as
    rank 0 of the step on four real gloo ranks; every rank of those issued
    the same."""
    fake = _run(f"""
        import json, torch
        torch.set_num_threads(1)
        from torch._subclasses.fake_tensor import FakeTensorMode
        from repro_torch.configs import get_config
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import fake_world
        from torch_scripts import DRYRUN_STEP, dryrun_step

        cfg = get_config(DRYRUN_STEP[0]).reduced()
        with fake_world(4, device_type="cpu", shape=(2, 2), axes=("data", "model")) as mesh:
            with FakeTensorMode(allow_non_fake_inputs=True):
                step, args, lm = dryrun_step(cfg, mesh)
                got = dryrun.trace_step(step, args, lm)
        print(json.dumps({{"calls": got["calls"], "ops": got["kernel_ops"]}}))
        """)
    ranks = spawn(dryrun_gloo_collectives, 4, timeout=600)
    assert all(r == ranks[0] for r in ranks)
    assert fake["calls"] == {k: list(v) for k, v in ranks[0].items()}
    from repro_torch.launch.dryrun import collective_bytes

    breakdown = collective_bytes(fake["calls"])
    assert breakdown == collective_bytes(ranks[0]) and breakdown["total"] > 0
    # a flash call a layer in each microbatch's forward and its recompute
    cfg = get_config(DRYRUN_STEP[0]).reduced()
    assert fake["ops"]["flash_fwd"] == 2 * cfg.microbatches * cfg.n_layers == 16


def test_remat_and_seq_shard_change_the_train_and_prefill_traces_not_decode():
    """The reduced gemma-2b's cells on a (2, 2) fake mesh under the
    dry-run's --remat (full / dots) and --seq-shard (on / off): "dots"
    recomputes fewer FLOPs than "full" in the train step; the residual split
    over S holds less temporary memory than whole in the train step (the
    checkpoints' inputs), and issues other collectives in the train and
    prefill steps; a decode step (S = 1, no gradient) is the same under all
    four."""
    got = _run("""
        import dataclasses, json, torch
        torch.set_num_threads(1)
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import fake_world

        out = {}
        with fake_world(4, device_type="cpu", shape=(2, 2), axes=("data", "model")) as mesh:
            for shape in ("train_4k", "prefill_32k", "decode_32k"):
                for remat in ("full", "dots"):
                    for seq in ("on", "off"):
                        cfg = dryrun.effective_config("gemma-2b", remat=remat,
                                                      seq_shard=seq == "on")
                        cfg = dataclasses.replace(cfg.reduced(), microbatches=1)
                        got, _ = dryrun.trace_cell("gemma-2b", shape, mesh, cfg=cfg)
                        out[f"{shape} {remat} {seq}"] = {
                            "flops": got["flops"], "bytes": got["bytes"], "calls": got["calls"],
                            "temp": got["memory"]["temp_size_in_bytes"],
                            "ops": got["kernel_ops"]}
        print(json.dumps(out))
        """, timeout=600)
    train = {k.split(" ", 1)[1]: v for k, v in got.items() if k.startswith("train_4k")}
    for seq in ("on", "off"):
        assert train[f"dots {seq}"]["flops"] < train[f"full {seq}"]["flops"], seq
        assert train[f"dots {seq}"]["ops"] == train[f"full {seq}"]["ops"], seq
    for remat in ("full", "dots"):
        assert train[f"{remat} on"]["temp"] < train[f"{remat} off"]["temp"], remat
        assert train[f"{remat} on"]["calls"] != train[f"{remat} off"]["calls"], remat
    prefill = {k.split(" ", 1)[1]: v for k, v in got.items() if k.startswith("prefill_32k")}
    assert prefill["dots on"] == prefill["full on"] and prefill["dots off"] == prefill["full off"]
    assert prefill["dots on"]["calls"] != prefill["dots off"]["calls"]
    decode = [v for k, v in got.items() if k.startswith("decode_32k")]
    assert all(v == decode[0] for v in decode)
