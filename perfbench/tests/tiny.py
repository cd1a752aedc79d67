"""A throwaway benchmark for the CPU tests: a copy of the benchmark's folder
with small cells added as new files only (configurations at the program's
``reduced()`` sizes, short mixes, their checks) and ``BENCHMARK.json``
listing them, in a temporary directory."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent

MOE = {"name": "tiny-moe", "family": "moe", "n_layers": 2, "d_model": 64, "n_heads": 4,
       "kv_heads": 2, "head_dim": 16, "d_ff": 32, "vocab": 256,
       "moe": {"n_experts": 8, "top_k": 2, "d_ff_expert": 32}, "moe_every": 1,
       "act": "swiglu", "norm": "rmsnorm", "rope_theta": 10000.0, "moe_cf": 1.25,
       "tie_embeddings": False, "remat_policy": "dots", "microbatches": 1}
MAMBA = {"name": "tiny-mamba", "family": "ssm", "n_layers": 2, "d_model": 64, "n_heads": 8,
         "kv_heads": 0, "d_ff": 0, "vocab": 256,
         "mamba": {"d_state": 16, "d_conv": 4, "expand": 2, "head_dim": 16},
         "act": "swiglu", "norm": "rmsnorm", "tie_embeddings": True, "microbatches": 1,
         "remat_policy": "dots", "pure_dp": True}
SERVE = {"weight_dtype": "bfloat16", "compute_dtype": "bfloat16", "attn_backend": "auto"}
TRAIN = {"param_dtype": "float32", "compute_dtype": "bfloat16", "attn_backend": "auto",
         "remat_policy": "dots",
         "optimizer": {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1}}
PREFILL = {"kind": "prefill", "entry": "prefill", "slots": 4, "pad_token": 0,
           "lengths": {"dist": "lognormal", "median": 32, "sigma": 0.7, "min": 16, "max": 64},
           "cycle_requests": 16, "layout_seed": 0}
TRAINMIX = {"kind": "train", "entry": "train", "batch": 4, "seq_len": 32, "microbatches": 1,
            "prefetch_depth": 2, "checked_steps": 3}
# limits of the small cells: far above what sound CPU runs read (served gaps
# ~1e-2, norm gaps ~1e-2) and far below what the planted faults read
CHECKS = {
    "tiny-moe.tiny-prefill": {"check": {"stride": 2},
                              "numbers": {"logit_gap": {"limit": 0.3},
                                          "route_shortfall": {"limit": 0.05}}},
    "tiny-mamba.tiny-prefill": {"check": {"stride": 2},
                                "numbers": {"served_gap": {"limit": 0.5}}},
    "tiny-mamba.tiny-train": {"numbers": {"loss_gap": {"limit": 0.01}, "grad_gap": {"limit": 0.1},
                                          "delta_gap": {"limit": 0.1}}},
}
CELLS = [("tiny-moe", "tiny-prefill"), ("tiny-mamba", "tiny-prefill"),
         ("tiny-mamba", "tiny-train")]


def make_bench(tmp: Path) -> Path:
    """The throwaway checkout: ``tmp/BENCHMARK.json`` and ``tmp/perfbench``,
    with the small cells' files added; returns ``tmp``."""
    tmp = Path(tmp)
    shutil.copytree(HERE, tmp / "perfbench", ignore=shutil.ignore_patterns("out", "__pycache__"))
    root = tmp / "perfbench"
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for prog, ref in ((MOE, "moe_decoder"), (MAMBA, "mamba2")):
        # the small Mamba pads its groups to whole chunks of 16, as the full one does to 256
        serve = dict(SERVE, pad_multiple=16) if ref == "mamba2" else SERVE
        doc = {"name": prog["name"], "source": "small copy for tests", "reduced": [],
               "reference": ref, "program": prog, "serve": serve, "train": TRAIN}
        (root / "configs" / f"{prog['name']}.json").write_text(json.dumps(doc))
        bench["configs"].append({"name": prog["name"], "source": "tests",
                                 "file": f"perfbench/configs/{prog['name']}.json",
                                 "reduced": [], "why": "tests"})
    (root / "traffic" / "tiny-prefill.json").write_text(json.dumps(PREFILL))
    (root / "traffic" / "tiny-train.json").write_text(json.dumps(TRAINMIX))
    for name, checks in CHECKS.items():
        (root / "checks" / f"{name}.json").write_text(json.dumps(checks))
    for cfg, mix in CELLS:
        name = f"{cfg}.{mix}"
        bench["workloads"].append({"name": name, "config": cfg, "traffic": mix, "chips": 1,
                                   "why": "tests"})
        kind = "train" if mix.endswith("train") else "prefill"
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and any(w.endswith(f".{'train-2k' if kind == 'train' else 'prefill-backlog'}")
                                        for w in m["workloads"]):
                if (kind == "prefill" and cfg == "tiny-mamba" and m["name"].startswith(
                        ("flash", "moe_share"))) or (cfg == "tiny-moe" and m["name"].startswith("ssd")):
                    continue
                m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp


def cell(tmp: Path, name: str):
    import sys

    import torch

    torch.set_num_threads(2)  # small products: more threads only contend
    sys.path[:0] = [str(tmp / "perfbench"), str(REPO / "src")]
    import harness

    return harness.load_cell(name, tmp / "BENCHMARK.json", tmp / "perfbench")
