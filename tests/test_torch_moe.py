"""The port's MoE block (``repro_torch.models.moe``, the reference's ``local``
mode) against the reference's (``repro.models.moe``) on the same
numpy-seeded weights and inputs, float32 on the CPU. Bar as
``tests/test_moe.py``: atol 1e-5, rtol 1e-4; dispatch positions, top-k ids
and capacity equal; aux within rel 1e-6."""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64 as in the reference's own test runs)
import jax
import jax.numpy as jnp
from repro.configs.base import ModelConfig as RefModelConfig
from repro.configs.base import MoESpec as RefMoESpec
from repro.models import moe as RMOE
from repro.models.layers import Runtime as RefRuntime
from repro_torch.configs.base import ModelConfig, MoESpec
from repro_torch.models import moe as MOE
from repro_torch.models.layers import Runtime

REF_RT = RefRuntime(mesh=None, data_axes=("data",), compute_dtype=jnp.float32)
RT = Runtime("cpu", torch.float32)
EK = [(8, 1), (8, 2), (16, 4)]


@pytest.fixture(autouse=True)
def _forward_only():
    """The port's parameters are trainable: these forward checks run without
    recording an autograd graph (as the serving entry points do)."""
    with torch.no_grad():
        yield


def _cfgs(E, k, d=32, f=64):
    kw = dict(name="t", family="moe", n_layers=1, d_model=d, n_heads=4, kv_heads=4, d_ff=f,
              vocab=64)
    return (ModelConfig(moe=MoESpec(n_experts=E, top_k=k, d_ff_expert=f), **kw),
            RefModelConfig(moe=RefMoESpec(n_experts=E, top_k=k, d_ff_expert=f), **kw))


def _block(cfg, seed=0):
    """The port's MoE and the reference's leaves on the same weights, drawn
    with the reference's fan-in scales."""
    rng = np.random.default_rng(seed)
    d, E, f = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert
    leaves = {"router": d**-0.5 * rng.standard_normal((d, E)),
              "w_gate": d**-0.5 * rng.standard_normal((E, d, f)),
              "w_up": d**-0.5 * rng.standard_normal((E, d, f)),
              "w_down": f**-0.5 * rng.standard_normal((E, f, d))}
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    block = MOE.MoE(cfg, "cpu", torch.float32)
    for name, arr in leaves.items():
        getattr(block, name).copy_(torch.as_tensor(arr))
    return block, {k: jnp.asarray(v) for k, v in leaves.items()}


def _x(cfg, B, S, seed=1):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _compare(E, k, cf, B, S):
    cfg, rcfg = _cfgs(E, k)
    block, ref_p = _block(cfg)
    x = _x(cfg, B, S)
    want, want_aux = RMOE.apply_moe(ref_p, jnp.asarray(x), rcfg, REF_RT, cf=cf)
    with MOE.recording_routes() as routes:
        got, aux = MOE.apply_moe(block, torch.as_tensor(x), cfg, RT, cf=cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux))
    # the same routing: top-k ids of the reference's router on these inputs
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x), ref_p["router"]).astype(jnp.float32)
    _, want_ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    assert len(routes) == 1
    np.testing.assert_array_equal(routes[0].numpy(), np.asarray(want_ids))
    return routes[0], cfg


@pytest.mark.parametrize("E,k", EK)
def test_moe_matches_reference_dropless(E, k):
    _compare(E, k, float(E), 2, 16)


@pytest.mark.parametrize("E,k", EK)
def test_moe_matches_reference_under_capacity_drops(E, k):
    """cf 0.25 drops most slots: a dropped slot must add zeros at position 0
    of its expert, never overwrite the token kept there."""
    B, S, cf = 2, 64, 0.25
    ids, cfg = _compare(E, k, cf, B, S)
    pos = MOE._dispatch_positions(ids.reshape(-1), E)
    C = MOE._capacity(B * S, k, E, cf)
    assert float((pos >= C).float().mean()) > 0.3  # most of the work is drops


@pytest.mark.parametrize("E,k", EK)
def test_moe_matches_dense_oracle_dropless(E, k):
    """Every expert computes every token, combined with the renormalised
    top-k probabilities: exact where capacity drops nothing."""
    cfg, _ = _cfgs(E, k)
    block, _ = _block(cfg)
    x = torch.as_tensor(_x(cfg, 2, 16))
    y, aux = MOE.apply_moe(block, x, cfg, RT, cf=float(E))
    probs = torch.softmax(x @ block.router, dim=-1)
    pk, ids = torch.topk(probs, k)
    pk = pk / pk.sum(-1, keepdim=True)
    gate = torch.einsum("bsd,edf->bsef", x, block.w_gate)
    up = torch.einsum("bsd,edf->bsef", x, block.w_up)
    y_all = torch.einsum("bsef,efd->bsed", torch.nn.functional.silu(gate) * up, block.w_down)
    y_sel = torch.take_along_dim(y_all, ids[..., None], dim=2)
    want = (y_sel * pk[..., None]).sum(dim=2)
    np.testing.assert_allclose(y.numpy(), want.numpy(), atol=1e-5, rtol=1e-4)
    assert float(aux) >= 1.0 - 1e-6  # Switch aux >= 1 (equality at uniform)


def test_dispatch_positions_and_capacity_match_reference():
    rng = np.random.default_rng(5)
    for E in (4, 8, 64):
        ids = rng.integers(0, E, 300)
        got = MOE._dispatch_positions(torch.as_tensor(ids), E).numpy()
        want = np.asarray(RMOE._dispatch_positions(jnp.asarray(ids, jnp.int32), E))
        np.testing.assert_array_equal(got, want)
    for n, k, E, cf in ((2048, 6, 64, 1.25), (4, 6, 64, 1.25), (16, 2, 8, 4.0), (128, 1, 8, 0.25)):
        assert MOE._capacity(n, k, E, cf) == RMOE._capacity(n, k, E, cf)
    assert MOE._capacity(2048, 6, 64, 1.25) == 240  # the moonshot prefill drops tokens


def test_router_stays_float32_and_runs_in_the_compute_dtype():
    """In a bf16 model the router leaf is float32, cast to bf16 before its
    product (as the reference does); the block's output is bf16."""
    cfg, _ = _cfgs(8, 2)
    block, _ = _block(cfg)
    bf = MOE.MoE(cfg, "cpu", torch.bfloat16)
    for name in ("router", "w_gate", "w_up", "w_down"):
        getattr(bf, name).copy_(getattr(block, name))
    assert bf.router.dtype == torch.float32 and bf.w_up.dtype == torch.bfloat16
    x = torch.as_tensor(_x(cfg, 2, 16)).to(torch.bfloat16)
    with MOE.recording_routes() as routes:
        y, aux = MOE.apply_moe(bf, x, cfg, Runtime("cpu", torch.bfloat16), cf=4.0)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    logits = (x @ bf.router.to(torch.bfloat16)).float()
    _, want = torch.topk(torch.softmax(logits, -1), 2)
    assert torch.equal(routes[0], want)


def test_top_k_orders_ties_as_the_reference():
    """Equal probabilities (bf16 router logits tie often) come out in the
    order of their expert index, as jax.lax.top_k orders them."""
    rng = np.random.default_rng(7)
    probs = rng.integers(0, 4, (64, 16)).astype(np.float32) / 4  # many exact ties
    for k in (1, 2, 6):
        pk, ids = MOE._top_k(torch.as_tensor(probs), k)
        want_pk, want_ids = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
        np.testing.assert_array_equal(pk.numpy(), np.asarray(want_pk))



def test_replaying_recorded_routes_reproduces_the_block():
    """replaying_routes feeds recorded expert ids back in place of the
    router's top-k: the same ids give the same output, and ids recorded on
    other inputs take effect (the router's probabilities at them weigh)."""
    cfg, _ = _cfgs(8, 2)
    block, _ = _block(cfg)
    x = torch.as_tensor(_x(cfg, 2, 16))
    with MOE.recording_routes() as routes:
        y, aux = MOE.apply_moe(block, x, cfg, RT, cf=0.5)
        MOE.apply_moe(block, torch.as_tensor(_x(cfg, 2, 16, seed=9)), cfg, RT, cf=0.5)
    with MOE.replaying_routes(routes[:1]), MOE.recording_routes() as replayed:
        y_again, aux_again = MOE.apply_moe(block, x, cfg, RT, cf=0.5)
    assert torch.equal(y, y_again) and torch.equal(aux, aux_again)
    assert torch.equal(replayed[0], routes[0])
    with MOE.replaying_routes(routes[1:]):
        y_forced, _ = MOE.apply_moe(block, x, cfg, RT, cf=0.5)
    assert not torch.allclose(y_forced, y)
    assert not MOE._ROUTE_SOURCES and not MOE._ROUTE_SINKS


# --- gradients (the autouse no_grad above is lifted inside these) -----------
def _moe_loss_grads(block, cfg, x, cf):
    """Gradients of sum(y²) + 0.01·aux with respect to the block's leaves and
    x, as tests/test_moe.py::test_moe_grads_flow forms the loss."""
    with torch.enable_grad():
        for p in block.parameters():
            p.grad = None
        xt = torch.tensor(x, requires_grad=True)
        y, aux = MOE.apply_moe(block, xt, cfg, RT, cf=cf)
        ((y ** 2).sum() + 0.01 * aux).backward()
    return {**{name: getattr(block, name).grad for name in ("router", "w_gate", "w_up",
                                                              "w_down")}, "x": xt.grad}


def test_moe_grads_flow():
    """As the reference's test: the router and every expert weight receive a
    non-zero gradient through the scatter (index_put_ with accumulate), the
    stable top-k gather and the renormalised probabilities."""
    cfg, _ = _cfgs(8, 2)
    block, _ = _block(cfg)
    grads = _moe_loss_grads(block, cfg, _x(cfg, 1, 8), 8.0)
    for name in ("router", "w_gate", "w_up", "w_down"):
        assert float(grads[name].abs().max()) > 0, name


@pytest.mark.parametrize("E,k,cf", [(8, 2, 8.0), (8, 1, 8.0), (16, 4, 0.5)])
def test_moe_grads_match_reference(E, k, cf):
    """Gradients of the leaves and of x against jax.grad of the reference's
    apply_moe on the same weights: atol 1e-5, rtol 1e-4; dropless at cf 8
    (the reference test's), and with capacity drops at cf 0.5."""
    cfg, rcfg = _cfgs(E, k)
    block, ref_p = _block(cfg)
    x = _x(cfg, 1 if cf == 8.0 else 2, 8 if cf == 8.0 else 32)

    def ref_loss(p, x):
        y, aux = RMOE.apply_moe(p, x, rcfg, REF_RT, cf=cf)
        return (y ** 2).sum() + 0.01 * aux

    want_p, want_x = jax.grad(ref_loss, argnums=(0, 1))(ref_p, jnp.asarray(x))
    got = _moe_loss_grads(block, cfg, x, cf)
    for name in ("router", "w_gate", "w_up", "w_down"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want_p[name]), atol=1e-5,
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want_x), atol=1e-5, rtol=1e-4)


def test_recomputing_records_nothing_and_replays_the_forwards_ids():
    """moe.recomputing (a checkpointed layer's recompute) hides the open
    recording blocks and, given ids, replays them; the sinks are restored
    after it, and nested recording blocks are removed by identity."""
    cfg, _ = _cfgs(8, 2)
    block, _ = _block(cfg)
    x = torch.as_tensor(_x(cfg, 2, 16))
    with MOE.recording_routes() as outer, MOE.recording_routes() as inner:
        assert not MOE.replaying()
        with MOE.recomputing():
            MOE.apply_moe(block, x, cfg, RT, cf=0.5)
        assert outer == [] and inner == []
        forced = [torch.zeros((2, 16, 2), dtype=torch.int64)]
        with MOE.recomputing(forced), MOE.recording_routes() as during:
            assert MOE.replaying()
            MOE.apply_moe(block, x, cfg, RT, cf=0.5)
        assert torch.equal(during[0], forced[0]) and outer == [] and inner == []
        MOE.apply_moe(block, x, cfg, RT, cf=0.5)
    assert len(outer) == 1 and len(inner) == 1 and outer[0] is inner[0]
    assert not MOE._ROUTE_SOURCES and not MOE._ROUTE_SINKS
