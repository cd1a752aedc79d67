"""The port's examples (``examples_torch/``) on the CPU against the values the
reference's examples (``examples/``) print, recorded in
``tests/data/torch_fleet_binding_golden.json`` (regenerate with
``PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/test_torch_fleet.py``):

- quickstart: fitted κ within 1e-8 relative, counts exact, quotas, Ws,
  power and utility within rtol 1e-6, equal counters, the registry's names,
  and the ``crms_lifecycle`` / ``crms_failover`` fields;
- edge_crms_demo: containers per phase exact, mean responses within rtol
  1e-6 (the event simulator on the host), equal re-optimizations;
- serve_multitenant: the fleet plan on the port's own fit (counts exact,
  utility within rtol 1e-4 of the reference's, whose fit lands elsewhere on
  Eq. (1)'s flat ridge), the drift flags, both reduced tenants serving every
  request;
- train_small_lm --steps 12: the loss falls across one injected crash and
  restart (its weights come from another generator than the reference's).

Each example runs on the CUDA device unless ``--device`` names another.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config

from torch_scripts import chip_smoke

CPU = ["--device", "cpu"]
assert_same, load_script = chip_smoke.assert_same, chip_smoke.load_script


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def golden():
    return json.loads(chip_smoke.FLEET_BINDING_GOLDEN.read_text())["examples"]


def test_quickstart_matches_the_reference(golden):
    out = chip_smoke.plain(load_script("examples_torch/quickstart.py").main(CPU))
    ref = golden["quickstart"]
    np.testing.assert_allclose(out["kappa"], ref["kappa"], rtol=1e-8, atol=0)
    assert out["policies"] == ref["policies"]
    assert_same(ref["crms"], out["crms"], "quickstart.crms")
    assert_same(ref["crms_lifecycle"], out["crms_lifecycle"], "quickstart.crms_lifecycle")
    assert_same(ref["crms_failover"], out["crms_failover"], "quickstart.crms_failover")


def test_edge_crms_demo_matches_the_reference(golden):
    out = chip_smoke.plain(load_script("examples_torch/edge_crms_demo.py").main(CPU))
    ref = golden["edge_crms_demo"]
    assert_same(ref, out, "edge_crms_demo")
    assert out["reoptimizations"] == 3  # the jitter phase stays on the cached plan


def test_serve_multitenant_plans_drifts_and_serves(golden):
    demo = load_script("examples_torch/serve_multitenant.py")
    out = demo.main(CPU)
    ref = golden["serve_multitenant"]
    alloc, groups = out["alloc"], out["groups"]
    assert alloc.n.tolist() == ref["plan"]["n"]
    assert alloc.utility == pytest.approx(ref["plan"]["utility"],
                                          rel=chip_smoke.OWN_FIT_UTILITY_RTOL)
    assert [g.arch for g in groups] == [g[0] for g in ref["plan"]["groups"]]
    assert all(g.batch_slots >= 1 for g in groups)
    assert out["reoptimized"] == ref["reoptimized"] == [False, True]
    assert out["fleet"].device == "cpu"
    for arch in demo.TENANTS:
        vocab = get_config(arch).reduced().vocab
        assert sorted(out["served"][arch]) == [0, 1, 2]
        assert all(len(t) == 6 and all(0 <= x < vocab for x in t)
                   for t in out["served"][arch].values())


def test_train_small_lm_recovers_and_learns():
    out = load_script("examples_torch/train_small_lm.py").main([*CPU, "--steps", "12"])
    history = out["history"]
    assert out["restarts"] == 1
    assert history[-1]["step"] == 12
    assert history[-1]["loss"] < history[0]["loss"]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in history)


def test_examples_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("quickstart", "edge_crms_demo", "serve_multitenant", "train_small_lm"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_script(f"examples_torch/{name}.py").main([])
