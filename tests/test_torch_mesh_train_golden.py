"""The golden training runs on the mesh: ``chip_smoke.py``'s phase-23 part
(a) on four CPU ranks over gloo (a (2, 2) ("data", "model") mesh, float32,
the plain forwards): the five reduced entries of
``tests/data/torch_train_golden.json`` trained for 6 steps from
``interop.numpy_params`` weights, the MoE models on the reference's expert
ids (each rank replays its rows' ids). Each step's loss within rtol 1e-5
and grad_norm within 1e-4 of the reference's; every rank's curve the same.

Reduced jamba-1.5-large-398b is the exception the golden file already
records on one device: its port drifts from the reference by up to 2.2e-5
in the loss and 3.8e-5 in grad_norm over the 6 steps (AdamW's first steps
turn last-bit differences of near-zero gradients into updates of ±lr; see
tests/test_torch_train_step.py), so its mesh run is held to the port's
single-device run at 1e-5 / 1e-4 and to the golden file at phase 14's bars
(1e-4 / 1e-3).
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import spawn

from torch_scripts import chip_smoke, mesh_golden_cases

GOLDEN = json.loads((Path(__file__).resolve().parent / "data" /
                     "torch_train_golden.json").read_text())
DRIFTS_ON_ONE_DEVICE = "jamba-1.5-large-398b"


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ranks():
    return spawn(mesh_golden_cases, 4, args=(GOLDEN,), timeout=900)


def _rel(got, want):
    return float((np.abs(np.asarray(got) - want) / np.abs(want)).max())


@pytest.mark.parametrize("arch", list(GOLDEN["entries"]))
def test_mesh_training_matches_golden(ranks, arch):
    entry = GOLDEN["entries"][arch]
    curve = ranks[0][arch]["curve"]
    assert all(r[arch]["curve"] == curve for r in ranks)
    loss, gnorm = (np.array(c) for c in zip(*curve))
    assert np.all(np.isfinite(loss)) and loss[-1] < loss[0]
    if arch == DRIFTS_ON_ONE_DEVICE:
        single = chip_smoke.train_curve(get_config(arch).reduced(), GOLDEN["setup"], "cpu",
                                        routes=entry["routes"])
        want_loss, want_gnorm = (np.array(c) for c in zip(*single))
        assert _rel(loss, want_loss) < 1e-5 and _rel(gnorm, want_gnorm) < 1e-4
        bars = (1e-4, 1e-3)
    else:
        bars = (1e-5, 1e-4)
    assert _rel(loss, entry["loss"]) < bars[0], (loss.tolist(), entry["loss"])
    assert _rel(gnorm, entry["grad_norm"]) < bars[1], (gnorm.tolist(), entry["grad_norm"])


def test_mesh_golden_runs_launch_no_kernel_on_the_cpu(ranks):
    assert all(r["launches"] == [0, 0] for r in ranks)
