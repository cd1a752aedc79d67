"""The pod all-reduce, the Trainer, the checkpoints and the launcher on a
device mesh: four CPU ranks over gloo (one spawn group for the file).

* ``train.step.compress_allreduce_pod``: the reference's
  ``test_compress_allreduce_shapes`` on the port, bit for bit with the
  reference's own function on a 1-pod mesh (a (1, 4) ("pod", "data") mesh,
  a leaf split over 'data'), and on a (2, 2) mesh whose pods hold different
  gradients bit for bit with ``chip_smoke.compress_numpy``, the NumPy
  transcription of the reference's formula; the error state carried over
  two calls.
* The Trainer's crash-and-resume on the (2, 2) mesh: the crash fails the
  run on every rank (no rank restarts alone), fresh trainers resume from
  LATEST, and the parameters end within 1e-6 of an uninterrupted run.
* A checkpoint written on the mesh restores on one device bit for bit, and
  one written on one device restores onto the mesh bit for bit, in the
  parameters' placements.
* ``launch.train``'s body on the (2, 2) mesh (bf16 compute) trains; with
  ``--production-mesh`` a group of four ranks gets the mesh's RuntimeError.
"""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64 as in the reference's own test runs)
import jax
import jax.numpy as jnp
from repro.train.step import compress_allreduce_pod as ref_compress
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.launch.mesh import spawn
from repro_torch.train import checkpoint as ckpt

from torch_scripts import chip_smoke, mesh_loop_cases


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def one_device_params():
    cfg = get_config("gemma-2b").reduced()
    return cfg, interop.params_from_jax(interop.numpy_params(cfg, 1), cfg, "cpu")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, one_device_params):
    root = tmp_path_factory.mktemp("mesh_ckpt")
    _, lm = one_device_params
    ckpt.save(root / "one_device", 3, {"params": dict(lm.named_parameters())})
    out = spawn(mesh_loop_cases, 4, args=(str(root), str(root / "one_device")), timeout=900)
    return root, out


def test_compress_allreduce_shapes(ranks):
    """The reference's bars (the reduced gradient within one scale of the
    gradient, the error its residual) and the reference's own results bit for
    bit, on one pod."""
    _, out = ranks
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1), ("pod",))
    err = {"w": jnp.zeros(64, jnp.float32), "m": jnp.zeros((16, 24), jnp.float32)}
    for call in range(2):
        g = {k: jnp.asarray(v) for k, v in chip_smoke.pod_grads(0, call).items()}
        with mesh:
            red, new_err = ref_compress(g, mesh, err)
        g_in = {k: np.asarray(g[k]) + np.asarray(err[k]) for k in g}
        for r in out:
            got_red, got_err = r["compress_one_pod"][call]
            for k in g:
                np.testing.assert_array_equal(got_red[k], np.asarray(red[k]))
                np.testing.assert_array_equal(got_err[k], np.asarray(new_err[k]))
                scale = float(np.abs(g_in[k]).max()) / 127.0
                np.testing.assert_allclose(got_red[k], g_in[k], atol=scale)
                np.testing.assert_allclose(got_err[k], g_in[k] - got_red[k], atol=1e-6)
        err = new_err


def test_compress_allreduce_two_pods_bit_for_bit(ranks):
    _, out = ranks
    for rank, r in enumerate(out):
        worst, errors = chip_smoke.check_compress(r["compress_two_pods"])
        assert worst == 0.0
        pod = rank // 2
        for k, want in errors[pod].items():
            np.testing.assert_array_equal(r["compress_two_pods"][-1][1][k], want)
    # the pods' gradients differ, and their reduction is one value
    assert not np.array_equal(out[0]["compress_two_pods"][0][1]["w"],
                              out[2]["compress_two_pods"][0][1]["w"])
    np.testing.assert_array_equal(out[0]["compress_two_pods"][0][0]["w"],
                                  out[3]["compress_two_pods"][0][0]["w"])


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield "/".join(prefix), np.asarray(tree)


def test_trainer_recovers_on_mesh(ranks):
    _, out = ranks
    for r in out:
        error, resumed_from, restarts, step, ref, rec = r["recovery"]
        assert error == "injected failure at step 6"
        assert (resumed_from, restarts, step) == (4, 0, 12)
        ref, rec = dict(_leaves(ref)), dict(_leaves(rec))
        for path, want in ref.items():
            np.testing.assert_allclose(rec[path], want, rtol=0, atol=1e-6, err_msg=path)


def test_checkpoint_written_on_mesh_restores_on_one_device(ranks):
    root, _ = ranks
    cfg = get_config("gemma-2b").reduced()
    want = interop.params_from_jax(interop.numpy_params(cfg, 0), cfg, "cpu")
    like = interop.params_from_jax(interop.numpy_params(cfg, 2), cfg, "cpu")
    step, tree = ckpt.restore(root / "mesh", {"params": dict(like.named_parameters())})
    assert step == 1
    for name, p in want.named_parameters():
        assert torch.equal(tree["params"][name], p.detach()), name


def test_checkpoint_written_on_one_device_restores_on_mesh(ranks, one_device_params):
    _, out = ranks
    _, lm = one_device_params
    for r in out:
        assert any("Shard" in pl for pl in r["restored_placements"].values())
        for name, p in lm.named_parameters():
            np.testing.assert_array_equal(r["restored"][name], p.detach().numpy(), err_msg=name)


def test_launch_train_runs_on_mesh(ranks):
    _, out = ranks
    losses, restarts = out[0]["launch"]
    assert restarts == 0 and losses and np.all(np.isfinite(losses))
    assert all(r["launch"] == out[0]["launch"] for r in out)


def test_launch_train_production_mesh_needs_its_ranks(ranks):
    _, out = ranks
    for r in out:
        assert "needs 256 ranks but only 4 present" in r["production_error"]
