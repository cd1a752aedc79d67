"""The reference's remat policies in the port (``models/model.py::
_remat_policy``): "none" (no checkpoint), "full" (each layer recomputed
whole in the backward) and "dots" (the outputs of the products without
batch dims kept, the rest recomputed: ``checkpoint_dots_with_no_batch_dims``),
any other name behaving as "dots". Reduced gemma-2b, mamba2-130m,
moonshot-v1-16b-a3b and jamba-1.5-large-398b, float32 on the CPU,
``interop.numpy_params(cfg, 0)`` weights, the MoE models on the reference's
expert ids.

* One loss and its per-leaf gradients agree between the policies within
  1e-6 of each leaf's max |g|, and under "dots" within 1e-5 of ``jax.grad``
  of the reference's ``lm_loss`` under the same policy.
* Counted in the backward by a ``TorchDispatchMode``: under "dots" no
  ``mm`` / ``addmm`` / batch-1 ``bmm`` is recomputed (the backward runs as
  many as without a checkpoint: its gradients' own), under "full" every one
  of the forward's is run again; the flash and SSD operators run once per
  layer in the forward and once more in the recompute under "full" and
  "dots", as before the policies existed.
* The bytes of the storages the forward leaves alive for the backward
  (the autograd graph's saved tensors, the checkpoints' inputs and the
  products "dots" keeps; tracked by weak references to every storage the
  forward's operators return) order as "none" >= "dots" > "full".
  ``saved_tensors_hooks`` cannot count them: a checkpoint's own hooks take
  the place of any outer ones inside it, and the kept products are held by
  the policy's cache, not as saved tensors.
"""
import contextlib
import dataclasses
import gc

import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import set_checkpoint_early_stop

import repro.core  # noqa: F401  (x64 as in the reference's own test runs)
import jax
import jax.numpy as jnp
from repro.configs import get_config as ref_config
from repro.models.layers import Runtime as RefRuntime
from repro.models.model import apply_lm as ref_apply_lm
from repro.models.model import lm_loss as ref_lm_loss
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import moe as MOE
from repro_torch.models.layers import Runtime
from repro_torch.models import model as M
from repro_torch.models.model import lm_loss

ARCHS = ["gemma-2b", "mamba2-130m", "moonshot-v1-16b-a3b", "jamba-1.5-large-398b"]
POLICIES = ("none", "full", "dots", "checkpoint_dots")  # the last: any other name is "dots"
B, S = 2, 16
RT = Runtime("cpu", torch.float32)
REF_RT = RefRuntime(mesh=None, data_axes=("data",), compute_dtype=jnp.float32)
_aten = torch.ops.aten


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _is_dot(func, args) -> bool:
    """A product without batch dims, as the policy names them."""
    return func in (_aten.mm.default, _aten.addmm.default) or (
        func is _aten.bmm.default and args[0].shape[0] == 1)


class _Products(TorchDispatchMode):
    """Counts the products without batch dims run inside, and keeps a weak
    reference to the storage of every tensor the operators return."""

    def __init__(self):
        super().__init__()
        self.dots = 0
        self.storages = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.dots += _is_dot(func, args)
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                self.storages[st._cdata] = (StorageWeakRef(st), st.nbytes())
        return out

    def alive_bytes(self) -> int:
        gc.collect()
        return sum(n for ref, n in self.storages.values() if not ref.expired())


@contextlib.contextmanager
def _layer_products():
    """Counts the products without batch dims run inside the model's layers
    (``model._apply_layer``, wrapped meanwhile): yields [count]."""
    count, apply_layer = [0], M._apply_layer

    def counted(*args, **kwargs):
        with _Products() as inside:
            out = apply_layer(*args, **kwargs)
        count[0] += inside.dots
        return out

    M._apply_layer = counted
    try:
        yield count
    finally:
        M._apply_layer = apply_layer


class _OperatorCalls:
    """Counts the calls of the flash and SSD operators' wrappers
    (``ops.flash_attention`` / ``ops.ssd_chunks``) inside."""

    def __enter__(self):
        self.calls = {"flash": 0, "ssd": 0}
        self.saved = ops.flash_attention, ops.ssd_chunks
        flash, ssd = self.saved

        def flash_call(*args, **kwargs):
            self.calls["flash"] += 1
            return flash(*args, **kwargs)

        def ssd_call(*args, **kwargs):
            self.calls["ssd"] += 1
            return ssd(*args, **kwargs)

        ops.flash_attention, ops.ssd_chunks = flash_call, ssd_call
        return self.calls

    def __exit__(self, *exc):
        ops.flash_attention, ops.ssd_chunks = self.saved


def _batch(cfg):
    rng = np.random.default_rng(5)
    return (rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))


def _ref_routes(cfg, params, toks):
    """The expert ids of each MoE block of the reference's forward, in call
    order (an ordered callback on jax.lax.top_k; remat off, the same
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
    return [torch.as_tensor(np.array(r)).long() for r in recorded]


def _port_run(cfg, tree, toks, labels, routes):
    """One loss and its backward under ``cfg``'s policy: (loss, {name:
    grad}, products without batch dims in the forward (and of them those in
    the layers, which a checkpoint covers) and in the backward,
    operator calls of the forward and the backward, bytes the forward left
    alive)."""
    lm = interop.params_from_jax(tree, cfg, "cpu")
    with MOE.replaying_routes(routes) if routes else contextlib.nullcontext():
        with _OperatorCalls() as fwd_calls, _Products() as fwd, _layer_products() as in_layers:
            loss, _ = lm_loss(lm, cfg, RT, toks, labels)
        alive = fwd.alive_bytes()
        with _OperatorCalls() as bwd_calls, _Products() as bwd:
            loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in lm.named_parameters()}
    return {"loss": float(loss.detach()), "grads": grads, "fwd_dots": fwd.dots,
            "layer_dots": in_layers[0],
            "bwd_dots": bwd.dots, "fwd_calls": dict(fwd_calls), "bwd_calls": dict(bwd_calls),
            "alive_bytes": alive}


@pytest.fixture(scope="module")
def runs():
    out = {}
    for arch in ARCHS:
        base = get_config(arch).reduced()
        tree = interop.numpy_params(base, 0)
        toks, labels = _batch(base)
        routes = None
        if base.moe is not None:
            routes = _ref_routes(ref_config(arch).reduced(),
                                 jax.tree.map(jnp.asarray, tree), toks)
        out[arch] = {"tree": tree, "toks": toks, "labels": labels, "routes": routes}
        for policy in POLICIES:
            cfg = dataclasses.replace(base, remat_policy=policy)
            out[arch][policy] = _port_run(cfg, tree, toks, labels, routes)
    return out


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_policies_give_the_same_loss_and_gradients(runs, arch):
    want = runs[arch]["none"]
    for policy in POLICIES[1:]:
        got = runs[arch][policy]
        assert abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"]), policy
        assert sorted(got["grads"]) == sorted(want["grads"])
        for name, g in want["grads"].items():
            assert _rel_err(got["grads"][name], g) <= 1e-6, (policy, name)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield "/".join(prefix), np.asarray(tree)


# Reduced jamba-1.5-large-398b is held to the other policies only (above):
# under every policy, "none" too, its first Mamba layer's a_log gradient is
# 1.04e-5 to 1.06e-5 of the leaf's max |g| off the reference's float32
# jax.grad (the reference's own policies differ by up to 3.1e-6), the
# rounding of the two float32 SSD backwards, which the policies do not move.
@pytest.mark.parametrize("arch", ARCHS[:3])
def test_dots_matches_jax_grad_of_the_reference_under_dots(runs, arch):
    run = runs[arch]
    cfg = dataclasses.replace(ref_config(arch).reduced(), remat_policy="dots")
    params = jax.tree.map(jnp.asarray, run["tree"])
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: ref_lm_loss(p, cfg, REF_RT, run["toks"], run["labels"])[0]))(params)
    got = run["dots"]
    assert abs(got["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
    lm = interop.params_from_jax(run["tree"], get_config(arch).reduced(), "cpu")
    port = dict(_leaves(interop.params_to_jax(lm, get_config(arch).reduced(), got["grads"])))
    want = dict(_leaves(grads))
    assert sorted(port) == sorted(want)
    for path, w in want.items():
        err = float(np.abs(port[path] - w).max()) / max(float(np.abs(w).max()), 1e-30)
        assert err <= 1e-5, (path, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_recomputes_no_product_without_batch_dims(runs, arch):
    """The backward under "dots" runs as many mm / addmm / batch-1 bmm as
    without a checkpoint (its gradients' own): none is recomputed. Under
    "full" those the forward ran in the layers are run again, all of them
    where the recompute does not stop early (a layer's last product, whose
    output no gradient needs, is left out otherwise)."""
    run = runs[arch]
    assert run["none"]["layer_dots"] > 0
    for policy in POLICIES:
        assert run[policy]["fwd_dots"] == run["none"]["fwd_dots"], policy
        assert run[policy]["layer_dots"] == run["none"]["layer_dots"], policy
    assert run["dots"]["bwd_dots"] == run["none"]["bwd_dots"]
    assert 0 < run["full"]["bwd_dots"] - run["none"]["bwd_dots"] <= run["none"]["layer_dots"]
    cfg = dataclasses.replace(get_config(arch).reduced(), remat_policy="full")
    with set_checkpoint_early_stop(False):
        whole = _port_run(cfg, run["tree"], run["toks"], run["labels"], run["routes"])
    assert whole["bwd_dots"] == run["none"]["bwd_dots"] + run["none"]["layer_dots"]


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_operators_run_again_in_the_recompute(runs, arch):
    """The flash and SSD operators run once a layer in the forward, and
    under "full" and "dots" once more in the backward's recompute (a
    kernel is no product the policy keeps, as a pallas_call is none in the
    reference): the launches per step of the port before the policies."""
    cfg = get_config(arch).reduced()
    blocks = [kind for st in cfg.stages() for kind, _ in st.blocks for _ in range(st.repeat)]
    want = {"flash": blocks.count("self_attn") + blocks.count("cross_attn"),
            "ssd": blocks.count("mamba")}
    run = runs[arch]
    for policy in POLICIES:
        assert run[policy]["fwd_calls"] == want, policy
    assert run["none"]["bwd_calls"] == {"flash": 0, "ssd": 0}
    for policy in ("full", "dots", "checkpoint_dots"):
        assert run[policy]["bwd_calls"] == want, policy


@pytest.mark.parametrize("arch", ARCHS)
def test_saved_bytes_order_none_dots_full(runs, arch):
    run = runs[arch]
    alive = {policy: run[policy]["alive_bytes"] for policy in POLICIES}
    assert alive["none"] >= alive["dots"] > alive["full"], alive


@pytest.mark.parametrize("arch", ARCHS)
def test_any_other_policy_name_is_dots(runs, arch):
    run = runs[arch]
    for key in ("fwd_dots", "bwd_dots", "fwd_calls", "bwd_calls", "alive_bytes"):
        assert run["checkpoint_dots"][key] == run["dots"][key], key
    for name, g in run["dots"]["grads"].items():
        assert torch.equal(run["checkpoint_dots"]["grads"][name], g), name
