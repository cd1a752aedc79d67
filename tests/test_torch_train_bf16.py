"""One bf16-compute train step of the port against the reference's
(``repro.train.step``, its gradients by ``jax.grad``) on the CPU: reduced
gemma-2b, minitron-4b and mamba2-130m on the same ``interop.numpy_params``
weights (float32, cast to bf16 in the layers by both), the same batch (B 4,
S 32 from a seeded NumPy generator, two microbatches), the plain attention
and SSD routes of both (``attn_backend="reference"``), AdamW at 1e-3. The
gradients are AdamW's first moment after the step (0.1 g), as
``tests/test_torch_train_step.py`` takes them in float32.

Bars, the reference's bf16 bar (``tests/test_kernels.py``): loss and
grad_norm within 3e-2 relative; each gradient leaf within 3e-2 of its max
|g| wherever the reference's own bf16 gradient lies within 3e-2 of its
float32 gradient (the bar measures the port only where bf16 rounding leaves
the reference itself inside it). Every leaf of every model, those outside
that condition included (reduced minitron-4b's: ROADMAP Queue 3), lies no
farther from the reference's float32 gradient than NOISE times the
reference's bf16 gradient does: the two packages round the same bf16
products in different places, and a port op computing another function
would move its gradient off the float32 one."""
import dataclasses
import functools

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
from repro_torch.configs import get_config
from repro_torch.models.layers import Runtime
from repro_torch.train.optimizer import adamw
from repro_torch.train.step import make_train_step

ARCHS = ("gemma-2b", "minitron-4b", "mamba2-130m")
B, S, MB, SEED, LR = 4, 32, 2, 0, 1e-3
BAR = 3e-2  # the reference's bf16 bar, relative to the max
NOISE = 1.5  # the port's distance to the float32 gradient over the reference's bf16 one


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(v, np.float64)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _runs(arch):
    """{"port", "ref", "ref_f32"}: each (loss, grad_norm, {leaf: first moment})
    of one step (the port and the reference in bf16 compute, the reference
    in float32)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), microbatches=MB)
    rcfg = dataclasses.replace(ref_config(arch).reduced(), microbatches=MB)
    tree = interop.numpy_params(cfg, SEED)
    rng = np.random.default_rng(SEED + 1)
    batch = {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32) for k in ("tokens", "labels")}
    out = {}
    for name, dtype in (("ref", jnp.bfloat16), ("ref_f32", jnp.float32)):
        params = jax.tree.map(jnp.asarray, tree)
        opt = ref_optimizer.adamw(lr=LR)
        rt = RefRuntime(mesh=None, data_axes=("data",), compute_dtype=dtype,
                        attn_backend="reference")
        _, state, m = jax.jit(ref_make_train_step(rcfg, rt, opt))(
            params, opt.init(params), {k: jnp.asarray(v) for k, v in batch.items()})
        out[name] = (float(m["loss"]), float(m["grad_norm"]), _leaves(state["m"]))
    lm = interop.params_from_jax(tree, cfg, "cpu")
    opt = adamw(lr=LR)
    state = opt.init(dict(lm.named_parameters()))
    lm, state, m = make_train_step(cfg, Runtime("cpu", torch.bfloat16, "reference"), opt)(
        lm, state, batch)
    out["port"] = (float(m["loss"]), float(m["grad_norm"]),
                   _leaves(interop.params_to_jax(lm, cfg, state["m"])))
    return out


def _gap(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_step_loss_and_grad_norm_match_reference(arch):
    runs = _runs(arch)
    (loss, gnorm, _), (ref_loss, ref_gnorm, _) = runs["port"], runs["ref"]
    print(f"{arch}: loss {loss} / {ref_loss}, grad_norm {gnorm} / {ref_gnorm}")
    assert np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0
    assert abs(loss - ref_loss) <= BAR * abs(ref_loss)
    assert abs(gnorm - ref_gnorm) <= BAR * ref_gnorm


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_step_gradients_match_reference(arch):
    """Each leaf within 3e-2 of its max |g| where the reference's bf16
    gradient is within 3e-2 of its float32 one."""
    runs = _runs(arch)
    got, want, exact = runs["port"][2], runs["ref"][2], runs["ref_f32"][2]
    assert got.keys() == want.keys()
    held = 0
    for leaf in want:
        gap, noise = _gap(got[leaf], want[leaf]), _gap(want[leaf], exact[leaf])
        print(f"{arch} {leaf}: port - ref {gap:.3e}, ref bf16 - f32 {noise:.3e}")
        if noise <= BAR:
            held += 1
            assert gap <= BAR, (leaf, gap)
    assert held >= 3  # the head and the final norm at least


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_step_gradients_lie_as_near_float32_as_the_references(arch):
    """Every leaf: the port's bf16 gradient no farther from the reference's
    float32 gradient than NOISE times the reference's bf16 gradient."""
    runs = _runs(arch)
    got, want, exact = runs["port"][2], runs["ref"][2], runs["ref_f32"][2]
    for leaf in exact:
        port_err, ref_err = _gap(got[leaf], exact[leaf]), _gap(want[leaf], exact[leaf])
        print(f"{arch} {leaf}: port - f32 {port_err:.3e}, ref - f32 {ref_err:.3e}")
        assert port_err <= NOISE * ref_err, (leaf, port_err, ref_err)
