"""Serving slice of the PyTorch port: ``repro_torch.serve.Engine`` against the
JAX reference's ``repro.serve.engine.Engine`` on the same weights
(``interop.numpy_params``), float32 on the CPU.

``tests/data/torch_serve_golden.json`` records the reference's generated
tokens, their top-1/top-2 logit margins and the prefill's last-position
logits for the reduced configurations that ``chip_smoke.py`` serves on the
card; ``test_serve_golden_file_is_current`` recomputes it with ``repro`` so
the file cannot go stale. Regenerate it with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_serve.py
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64 as in the reference's own test runs)
import jax
import jax.numpy as jnp
from repro.configs import get_config as ref_config
from repro.models.layers import Runtime as RefRuntime
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import Request as RefRequest
from repro.serve.step import make_prefill_step as ref_prefill_step
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as port_kernel
from repro_torch.kernels import ssd as ssd_kernel
from repro_torch.models.layers import Runtime
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.step import make_prefill_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_serve_golden.json")
SEED = 0
# tests/test_fleet_engine.py::test_engine_generates_greedy_tokens
SETUP = {"slots": 2, "max_len": 48, "max_new": 6,
         "prompts": [list(range(1, 9)), list(range(3, 11))]}
# golden entries: name -> (arch, overrides of reduced())
ENTRIES = {
    "gemma-2b": ("gemma-2b", {}),
    "gemma-2b-hd256": ("gemma-2b", {"head_dim": 256}),
    "minitron-4b": ("minitron-4b", {}),
    "codeqwen1.5-7b": ("codeqwen1.5-7b", {}),
    "mamba2-130m": ("mamba2-130m", {}),
    "moonshot-v1-16b-a3b": ("moonshot-v1-16b-a3b", {}),
    "llama4-scout-17b-a16e": ("llama4-scout-17b-a16e", {}),
    "jamba-1.5-large-398b": ("jamba-1.5-large-398b", {}),
}
MARGIN = 1e-3  # tokens must agree where the reference's top-1/top-2 margin exceeds this
LOGIT_RTOL = 1e-4  # prefill logits, relative to their max |logit|


def _prompts():
    return [np.asarray(p, np.int32) for p in SETUP["prompts"]]


def _padded(prompts):
    S = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, S - len(p):] = p
    return toks


def _ref_run(name):
    """The reference's Engine on the entry's weights: tokens, the margin of
    each generated token (teacher-forced full forward over prompt + output)
    and the prefill's last-position logits."""
    arch, overrides = ENTRIES[name]
    cfg = ref_config(arch).reduced(**overrides)
    params = jax.tree.map(jnp.asarray, interop.numpy_params(cfg, SEED))
    rt = RefRuntime(mesh=None, compute_dtype=jnp.float32)
    eng = RefEngine(cfg, params, rt, slots=SETUP["slots"], max_len=SETUP["max_len"])
    for rid, p in enumerate(_prompts()):
        eng.submit(RefRequest(rid=rid, prompt=p, max_new=SETUP["max_new"]))
    tokens = [r.out for r in sorted(eng.run(), key=lambda r: r.rid)]
    toks = _padded(_prompts())
    S = toks.shape[1]
    prefill = ref_prefill_step(cfg, rt)
    full = np.concatenate([toks, np.asarray(tokens, np.int32)[:, :-1]], axis=1)
    logits = np.asarray(prefill(params, {"tokens": jnp.asarray(toks)}), np.float64)
    from repro.models.model import apply_lm

    forced, _ = apply_lm(params, cfg, rt, jnp.asarray(full))
    forced = np.sort(np.asarray(forced, np.float64)[:, S - 1:], axis=-1)
    margins = forced[..., -1] - forced[..., -2]
    return {"arch": arch, "overrides": overrides, "tokens": tokens,
            "margins": margins.tolist(), "prefill_logits": logits.tolist()}


def _port_run(name, device="cpu", attn_backend="auto"):
    arch, overrides = ENTRIES[name]
    cfg = get_config(arch).reduced(**overrides)
    lm = interop.params_from_jax(interop.numpy_params(cfg, SEED), cfg, device)
    rt = Runtime(device, torch.float32, attn_backend)
    eng = Engine(cfg, lm, rt, slots=SETUP["slots"], max_len=SETUP["max_len"])
    for rid, p in enumerate(_prompts()):
        eng.submit(Request(rid=rid, prompt=p, max_new=SETUP["max_new"]))
    tokens = [r.out for r in sorted(eng.run(), key=lambda r: r.rid)]
    logits = make_prefill_step(cfg, rt)(lm, {"tokens": _padded(_prompts())})
    return tokens, logits.double().cpu().numpy()


def assert_matches_golden(entry, tokens, logits):
    """Tokens equal up to the first position whose golden margin is within
    MARGIN (after it the histories differ); prefill logits within LOGIT_RTOL
    of the golden's, relative to their max |logit|."""
    for got, want, margins in zip(tokens, entry["tokens"], entry["margins"]):
        assert len(got) == len(want)
        for g, w, m in zip(got, want, margins):
            if g != w:
                assert m <= MARGIN, (got, want, margins)
                break
    want = np.asarray(entry["prefill_logits"])
    err = np.max(np.abs(logits - want)) / np.max(np.abs(want))
    assert err < LOGIT_RTOL, err


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["gemma-2b", "mamba2-130m"])
def test_engine_tokens_match_reference_engine(name):
    """The reduced gemma-2b and mamba2-130m through both engines: identical
    tokens."""
    want = _ref_run(name)
    tokens, logits = _port_run(name)
    assert tokens == want["tokens"]
    assert all(len(t) == SETUP["max_new"] for t in tokens)
    assert_matches_golden(want, tokens, logits)


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_port_engine_matches_golden(golden, name):
    """Every golden entry (the cases chip_smoke.py serves on the card), on the
    CPU: the plain versions of the flash and SSD chunk kernels in prefill."""
    before = port_kernel.launches, ssd_kernel.launches
    tokens, logits = _port_run(name)
    assert (port_kernel.launches, ssd_kernel.launches) == before  # CPU tensors never reach them
    assert_matches_golden(golden["entries"][name], tokens, logits)


def test_serve_golden_file_is_current(golden):
    assert golden["setup"] == SETUP and golden["seed"] == SEED
    assert sorted(golden["entries"]) == sorted(ENTRIES)
    for name in sorted(ENTRIES):
        live = _ref_run(name)
        entry = golden["entries"][name]
        assert entry["tokens"] == live["tokens"], name
        assert (entry["arch"], entry["overrides"]) == (live["arch"], live["overrides"])
        np.testing.assert_allclose(entry["margins"], live["margins"], rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(entry["prefill_logits"], live["prefill_logits"],
                                   rtol=1e-9, atol=1e-12)


def test_launch_serve_demo_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--demo", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [f"req {i}" for i in range(4)]
    assert all(len(json.loads(ln.split(":", 1)[1])) == 8 for ln in lines)


def test_launch_serve_needs_demo(monkeypatch):
    """Without --demo the launcher runs the fleet plan (the reference's
    default), on the CUDA device unless --device names another: no card, no
    plan."""
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main([])
    with pytest.raises(SystemExit):
        serve.main(["--chips"])


def write_golden(path=GOLDEN):
    entries = {}
    for name in ENTRIES:
        entries[name] = _ref_run(name)
        print(name, entries[name]["tokens"], flush=True)
    doc = {
        "about": "repro (JAX, CPU, float32 compute) Engine results on interop.numpy_params "
                 "weights; margins are top-1 minus top-2 logits of a teacher-forced forward",
        "seed": SEED, "setup": SETUP, "entries": entries,
    }
    with open(path, "w") as f:
        json.dump(doc, f)
        f.write("\n")


if __name__ == "__main__":
    write_golden(sys.argv[1] if len(sys.argv) > 1 else GOLDEN)
