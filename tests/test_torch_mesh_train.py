"""The port's sharded train step on a device mesh against the reference:
four CPU ranks over gloo (``launch.mesh.spawn``, one group for the file) on
a (2, 2) ("data", "model") mesh, float32, ``interop.numpy_params(cfg, 0)``
weights on both sides.

* The reference's ``tests/test_sharding.py::test_train_step_runs_on_mesh``
  on the port: reduced codeqwen1.5-7b, two microbatches, the same batch
  twice, the loss falls.
* One loss's per-leaf gradients, gathered whole, within 1e-5 of each
  leaf's max |g| of ``jax.grad`` of the reference's ``lm_loss``, and the
  loss within 1e-5 relative, in each shard mode
  (``torch_scripts.GRAD_CASES``): reduced gemma-2b (sequence mode, the tied
  512-word head), codeqwen (heads on KV, the qkv biases), moonshot (the MoE's
  a2a mode on the reference's expert ids), mamba2-130m (pure data parallel),
  gemma-2b with its G query heads split, and with no split of its
  attention (every rank whole); the cases whose S splits run with the
  residual split over S between the layers (the configs' default sequence
  parallelism) and again with it whole (``*_whole``).
* The residual a layer takes holds S / 2 rows on a rank exactly where the
  reference's ``residual_constrain`` shards it (S splits, a model axis,
  sequence parallelism on), and S rows elsewhere.
* The train step's gradients (two microbatches) within 1e-5 of
  ``jax.grad`` of the microbatches' mean loss, with the moved weights held
  for the step (``layers.held_weights``), without, and held up to a budget
  that holds some; the hold issues fewer collectives.
* One Adafactor step on the mesh (its factored moments and RMS reduced over
  the split dims) within 1e-6 of the port's single-device step and 1e-5 of
  the reference's ``adafactor``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64 as in the reference's own test runs)
import jax
import jax.numpy as jnp
from repro.configs import get_config as ref_config
from repro.models.layers import Runtime as RefRuntime
from repro.models.model import apply_lm as ref_apply_lm
from repro.models.model import lm_loss as ref_lm_loss
from repro.train import optimizer as ref_optimizer
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.launch.mesh import spawn
from repro_torch.train.optimizer import adafactor

from torch_scripts import (GRAD_CASES, HOLDS, STEP_CASES, adafactor_grads, grad_batch,
                           mesh_train_cases, residual_rows)

REF_RT = RefRuntime(mesh=None, data_axes=("data",), compute_dtype=jnp.float32)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref_routes(cfg, params, toks):
    """The expert ids (B, S, k) of each MoE block of the reference's forward,
    in call order (an ordered callback on jax.lax.top_k; remat off, the same
    values)."""
    recorded, top_k = [], jax.lax.top_k

    def recording_top_k(x, k):
        values, ids = top_k(x, k)
        jax.debug.callback(lambda a: recorded.append(np.asarray(a)), ids, ordered=True)
        return values, ids

    eager = dataclasses.replace(cfg, remat_policy="none")
    jax.lax.top_k = recording_top_k
    try:
        jax.block_until_ready(jax.jit(lambda p, t: ref_apply_lm(p, eager, REF_RT, t, {}))(
            params, toks))
        jax.effects_barrier()
    finally:
        jax.lax.top_k = top_k
    return recorded


def _ref_case(name):
    arch, changes, B, S = GRAD_CASES[name]
    cfg = ref_config(arch).reduced(**changes)
    params = jax.tree.map(jnp.asarray, interop.numpy_params(get_config(arch).reduced(**changes),
                                                            0))
    toks, labels = grad_batch(cfg, B, S)
    return cfg, params, toks, labels


@pytest.fixture(scope="module")
def ranks():
    routes = {}
    for name in GRAD_CASES:
        cfg, params, toks, _ = _ref_case(name)
        if cfg.moe is not None:
            routes[name] = _ref_routes(cfg, params, toks)
    return spawn(mesh_train_cases, 4, args=(routes,), timeout=600)


def test_train_step_runs_on_mesh(ranks):
    losses = ranks[0]["runs_on_mesh"]
    assert all(r["runs_on_mesh"] == losses for r in ranks)
    assert np.all(np.isfinite(losses)) and losses[1] < losses[0]


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield "/".join(prefix), np.asarray(tree)


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_sharded_gradients_match_jax_grad(ranks, name):
    cfg, params, toks, labels = _ref_case(name)
    loss, grads = jax.value_and_grad(
        lambda p: ref_lm_loss(p, cfg, REF_RT, toks, labels)[0])(params)
    want = dict(_leaves(grads))
    for r in ranks:
        got_loss, got = r["grads"][name]
        assert abs(got_loss - float(loss)) <= 1e-5 * abs(float(loss))
        got = dict(_leaves(got))
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            scale = max(float(np.abs(w).max()), 1e-30)
            err = float(np.abs(got[path] - w).max()) / scale
            assert err <= 1e-5, (name, path, err)


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_residual_between_layers_is_the_references_layout(ranks, name):
    arch, changes, B, S = GRAD_CASES[name]
    want = residual_rows(get_config(arch).reduced(**changes), S)
    assert want == (S if name in ("mamba", "unsplit") or name.endswith("_whole") else S // 2)
    for r in ranks:
        assert r["residual_rows"][name] == {want}, (name, r["residual_rows"][name])


@pytest.mark.parametrize("name", STEP_CASES)
def test_train_step_gradients_match_jax_grad(ranks, name):
    """The train step's gradient (two microbatches) with the moved weights
    held for the step, without, and held up to a budget that holds some of
    them, within 1e-5 of jax.grad of the mean of the two microbatches'
    losses; the hold issues fewer collectives."""
    cfg, params, toks, labels = _ref_case(name)
    h = len(toks) // 2

    def step_loss(p):
        return (ref_lm_loss(p, cfg, REF_RT, toks[:h], labels[:h])[0]
                + ref_lm_loss(p, cfg, REF_RT, toks[h:], labels[h:])[0]) / 2

    loss, grads = jax.value_and_grad(step_loss)(params)
    want = dict(_leaves(grads))
    for r in ranks:
        for hold, (got_loss, got, _) in r["step"][name].items():
            assert abs(got_loss - float(loss)) <= 1e-5 * abs(float(loss)), (hold, got_loss)
            got = dict(_leaves(got))
            assert sorted(got) == sorted(want)
            for path, w in want.items():
                scale = max(float(np.abs(w).max()), 1e-30)
                err = float(np.abs(got[path] - w).max()) / scale
                assert err <= 1e-5, (name, hold, path, err)
        calls = {hold: r["step"][name][hold][2] for hold in HOLDS}
        assert calls["all"] < calls["some"] < calls["none"], calls


def test_adafactor_on_mesh_matches_one_device_and_reference(ranks):
    cfg = get_config("gemma-2b").reduced()
    tree = interop.numpy_params(cfg, 0)
    lm = interop.params_from_jax(tree, cfg, "cpu")
    params = dict(lm.named_parameters())
    grads = adafactor_grads(lm)
    assert any("Shard(dim=1)" in pl for pl in ranks[0]["placements"].values())
    opt = adafactor(lr=1e-3)
    opt.update({n: torch.as_tensor(g) for n, g in grads.items()}, opt.init(params), params)
    single = dict(_leaves(interop.params_to_jax(lm, cfg)))
    ref_opt = ref_optimizer.adafactor(lr=1e-3)
    ref_grads = interop.params_to_jax(lm, cfg, {n: torch.as_tensor(g) for n, g in grads.items()})
    ref_params = jax.tree.map(jnp.asarray, tree)
    ref_new, _ = ref_opt.update(jax.tree.map(jnp.asarray, ref_grads), ref_opt.init(ref_params),
                                ref_params)
    ref_new = dict(_leaves(ref_new))
    for r in ranks:
        got = dict(_leaves(r["adafactor"]))
        for path, w in single.items():
            np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-6, err_msg=path)
            np.testing.assert_allclose(got[path], ref_new[path], rtol=0, atol=1e-5,
                                       err_msg=path)
