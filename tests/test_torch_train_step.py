"""The port's train step (``repro_torch.train.step.make_train_step``) against
the reference's (``repro.train.step``) on the same weights
(``interop.numpy_params``) and batches, float32 on the CPU (the plain
versions of the flash and SSD kernels, their plain backwards). Bars: one
step of each of the ten reduced architectures as the reference's
``test_train_step_smoke`` sets it up (B 4, S 16, two microbatches, AdamW at
1e-3): loss rtol 1e-5, grad_norm rtol 1e-4, each leaf's gradient within
1e-5 of its max |gradient| and the updated parameters within atol 1e-5 of
the reference's, the latter where |gradient| >= 1e-6 (see below); the
reference's short training (reduced gemma-2b, lr 3e-3, 12 steps): each
step's loss within rtol 1e-4 of the JAX run's and the last below 0.8 x the
first.

AdamW's first step moves a parameter by lr · g / (|g| + 1e-8): where |g| is
within a few orders of magnitude of 1e-8 that ratio turns the rounding of
the gradient (the two implementations sum in different orders, which
leaves their gradients up to a few 1e-6 of a leaf's max apart in the
deeper models) into an update anywhere in ±lr.
Gradients that are 0 in exact arithmetic hit this: a key bias (codeqwen's
``bk``) shifts every score of a query alike, which softmax ignores. So the
updated parameters are held to atol 1e-5 where |g| >= 1e-6 (100 x eps: a
relative change of g there moves the ratio by at most 0.01 of it), and the
gradient itself (the first moment m = 0.1 g after one step) everywhere."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64 as in the reference's own test runs)
import jax
import jax.numpy as jnp
from repro.configs import get_config as ref_config
from repro.models.layers import Runtime as RefRuntime
from repro.train import optimizer as ref_optimizer
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import moe as MOE
from repro_torch.models.layers import Runtime
from repro_torch.models.model import lm_loss
from repro_torch.train.optimizer import Optimizer, adamw
from repro_torch.train.step import make_train_step

REF_RT = RefRuntime(mesh=None, data_axes=("data",), compute_dtype=jnp.float32)
RT = Runtime("cpu", torch.float32)
SEED = 0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run many small CPU operations; with a test worker per core,
    torch's pool of one thread per core oversubscribes the CPU and slows them
    by tens of times, so each test runs on one thread (restored after)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _cfgs(arch, **overrides):
    return (dataclasses.replace(get_config(arch).reduced(), **overrides),
            dataclasses.replace(ref_config(arch).reduced(), **overrides))


def _batch(cfg, B, S, seed=1, label_vocab=None):
    """tokens, labels and the vlm / audio inputs as tests/test_models.py
    shapes them, from numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, label_vocab or cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal((B, cfg.n_patches, cfg.d_vision)).astype(np.float32)
    if cfg.family == "audio":
        frames = (B, max(S // cfg.enc_frames_ratio, 4), cfg.d_model)
        batch["frames"] = rng.standard_normal(frames).astype(np.float32)
    return batch


def _runs(cfg, rcfg, lr, batches):
    """Both train steps from the same numpy_params weights over ``batches``:
    (port metrics per step, reference metrics per step, port LM, reference
    parameters, port optimizer state, reference optimizer state)."""
    tree = interop.numpy_params(cfg, SEED)
    params = jax.tree.map(jnp.asarray, tree)
    ref_opt = ref_optimizer.adamw(lr=lr)
    ref_state = ref_opt.init(params)
    ref_step = jax.jit(ref_make_train_step(rcfg, REF_RT, ref_opt))
    lm = interop.params_from_jax(tree, cfg, "cpu")
    opt = adamw(lr=lr)
    state = opt.init(dict(lm.named_parameters()))
    step = make_train_step(cfg, RT, opt)
    got, want = [], []
    for batch in batches:
        params, ref_state, m = ref_step(params, ref_state,
                                        {k: jnp.asarray(v) for k, v in batch.items()})
        want.append({k: float(v) for k, v in m.items()})
        lm, state, m = step(lm, state, batch)
        got.append({k: float(v) for k, v in m.items()})
    return got, want, lm, params, state, ref_state


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_matches_reference(arch):
    cfg, rcfg = _cfgs(arch, microbatches=2)
    got, want, lm, params, state, ref_state = _runs(cfg, rcfg, 1e-3, [_batch(cfg, 4, 16)])
    (got,), (want,) = got, want
    assert np.isfinite(got["loss"]) and got["grad_norm"] > 0
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-4)
    assert got["aux"] == 0.0 and got["nll"] == got["loss"]  # as the reference sets them
    port_tree = interop.params_to_jax(lm, cfg)
    port_m = interop.params_to_jax(lm, cfg, state["m"])
    assert jax.tree.structure(port_tree) == jax.tree.structure(params)
    flat = jax.tree_util.tree_flatten_with_path(port_tree)[0]
    for (path, a), m, b, ref_m in zip(flat, jax.tree.leaves(port_m), jax.tree.leaves(params),
                                      jax.tree.leaves(ref_state["m"])):
        where = jax.tree_util.keystr(path)
        ref_m = np.asarray(ref_m)
        gap = np.max(np.abs(m - ref_m)) / max(np.max(np.abs(ref_m)), 1e-30)
        assert gap < 1e-5, (where, gap)
        conditioned = np.abs(ref_m / 0.1) >= 1e-6
        np.testing.assert_allclose(a[conditioned], np.asarray(b)[conditioned], atol=1e-5,
                                   rtol=0, err_msg=where)


def test_loss_decreases_in_short_training():
    """The reference's test_loss_decreases_in_short_training (learnable
    labels in [0, 16), the config's 4 microbatches) on both sides."""
    cfg, rcfg = _cfgs("gemma-2b")
    batch = _batch(cfg, 8, 32, label_vocab=16)
    got, want = _runs(cfg, rcfg, 3e-3, [batch] * 12)[:2]
    losses = [m["loss"] for m in got]
    np.testing.assert_allclose(losses, [m["loss"] for m in want], rtol=1e-4)
    assert losses[-1] < losses[0] * 0.8, losses


def test_single_microbatch_metrics_are_the_losses():
    """With one microbatch the metrics are lm_loss's nll and aux (here the
    MoE model's non-zero aux), as the reference's."""
    cfg, rcfg = _cfgs("moonshot-v1-16b-a3b", microbatches=1)
    (got,), (want,) = _runs(cfg, rcfg, 1e-3, [_batch(cfg, 2, 16)])[:2]
    for key in ("loss", "nll", "aux"):
        assert got[key] == pytest.approx(want[key], rel=1e-5), key
    assert got["aux"] > 0 and got["loss"] == pytest.approx(got["nll"] + 0.01 * got["aux"])


def test_microbatch_gradients_are_summed_in_float32():
    """With bf16 parameters the step sums each microbatch's gradient in
    float32 and divides by their number (the reference's scan carries
    float32 sums), rather than accumulating bf16 gradients."""
    cfg, _ = _cfgs("gemma-2b")
    lm = interop.params_from_jax(interop.numpy_params(cfg, SEED), cfg, "cpu", torch.bfloat16)
    batch = _batch(cfg, 4, 16)
    want = {n: torch.zeros(p.shape) for n, p in lm.named_parameters()}
    for i in range(2):
        loss, _ = lm_loss(lm, cfg, RT, batch["tokens"][2 * i:2 * i + 2],
                          batch["labels"][2 * i:2 * i + 2])
        for (n, p), g in zip(lm.named_parameters(), torch.autograd.grad(loss, lm.parameters())):
            assert g.dtype == p.dtype
            want[n] += g.float()
    seen = {}
    capture = Optimizer(init=lambda params: {}, update=lambda g, s, p: seen.update(g) or (p, s))
    make_train_step(cfg, RT, capture, microbatches=2)(lm, {}, batch)
    for n, g in seen.items():
        assert g.dtype == torch.float32 and torch.equal(g, want[n] / 2), n


@pytest.mark.parametrize("arch", ["gemma-2b", "jamba-1.5-large-398b", "seamless-m4t-large-v2"])
def test_remat_gives_the_gradients_of_the_plain_forward(arch):
    """Each layer under torch.utils.checkpoint (remat_policy "dots") gives the
    loss and gradients of the forward without it, bit for bit on the CPU;
    each MoE layer's route is recorded once per forward, not again in the
    recompute, and replaying it reproduces the gradients."""
    cfg, _ = _cfgs(arch)
    tree = interop.numpy_params(cfg, SEED)
    batch = _batch(cfg, 2, 16)
    extra = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    n_moe = sum(st.repeat for st in cfg.stages() for kind, _ in st.blocks if kind == "moe")
    runs = {}
    for policy in ("dots", "none", "replay"):
        c = dataclasses.replace(cfg, remat_policy="dots" if policy == "replay" else policy)
        lm = interop.params_from_jax(tree, c, "cpu")
        with MOE.recording_routes() as routes, \
                MOE.replaying_routes(runs["dots"][2]) if policy == "replay" else \
                MOE.recording_routes():
            loss, _ = lm_loss(lm, c, RT, batch["tokens"], batch["labels"], extra)
            loss.backward()
        assert len(routes) == n_moe
        runs[policy] = (loss.detach(), [p.grad for p in lm.parameters()], routes)
    for policy in ("none", "replay"):
        assert torch.equal(runs[policy][0], runs["dots"][0])
        for a, b in zip(runs[policy][1], runs["dots"][1]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_to_jax_inverts_params_from_jax(arch):
    cfg = get_config(arch).reduced()
    tree = interop.numpy_params(cfg, SEED)
    back = interop.params_to_jax(interop.params_from_jax(tree, cfg, "cpu"), cfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == np.float32 and np.array_equal(a, b)
