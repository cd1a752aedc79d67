"""The port's dense model (``repro_torch.models``) against the reference's
(``repro.models``) on the same weights: ``interop.numpy_params`` draws a tree
in the reference's layout, ``params_from_jax`` loads it into the port's
``LM``. Reduced configurations, float32 compute, CPU (the flash attention's
plain version). Bars as ``tests/test_models.py``: logits within 1e-4 of
the reference relative to their max |logit|, decode equal to the full
forward within 1e-4."""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64 as in the reference's own test runs)
import jax
import jax.numpy as jnp
from repro.configs import get_config as ref_config
from repro.models import layers as RL
from repro.models.model import apply_decode as ref_apply_decode
from repro.models.model import apply_lm as ref_apply_lm
from repro.models.model import init_cache as ref_init_cache
from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import layers as L
from repro_torch.models.layers import Runtime
from repro_torch.models.model import LM, apply_decode, apply_lm, init_cache, init_params

DENSE = ["gemma-2b", "minitron-4b", "codeqwen1.5-7b", "command-r-plus-104b"]
REF_RT = RL.Runtime(mesh=None, data_axes=("data",), compute_dtype=jnp.float32)
RT = Runtime("cpu", torch.float32)
SEED = 0


def _models(arch):
    cfg = get_config(arch).reduced()
    tree = interop.numpy_params(cfg, SEED)
    return cfg, ref_config(arch).reduced(), interop.params_from_jax(tree, cfg, "cpu"), \
        jax.tree.map(jnp.asarray, tree)


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("arch", DENSE)
def test_apply_lm_matches_reference(arch):
    cfg, rcfg, lm, params = _models(arch)
    toks = _tokens(cfg, 2, 32)
    want, want_aux = ref_apply_lm(params, rcfg, REF_RT, jnp.asarray(toks))
    got, aux = apply_lm(lm, cfg, RT, torch.as_tensor(toks))
    assert got.shape == (2, 32, cfg.vocab) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < 1e-4
    assert float(aux) == float(want_aux) == 0.0


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_full_forward(arch):
    cfg, rcfg, lm, params = _models(arch)
    B, S = 2, 16
    toks = torch.as_tensor(_tokens(cfg, B, S))
    full, _ = apply_lm(lm, cfg, RT, toks)
    cache = init_cache(cfg, RT, B, max_len=S, dtype=torch.float32)
    steps = []
    for t in range(S):
        lg, cache = apply_decode(lm, cfg, RT, toks[:, t:t + 1], cache, t)
        steps.append(lg[:, 0])
    assert _rel(torch.stack(steps, dim=1).numpy(), full.numpy()) < 1e-4
    assert torch.all(cache["stage0"]["b0"]["index"] == S - 1)


def test_prefill_fill_then_decode_continues():
    """As the reference's test: decode after a prefill + replay matches the
    token-by-token path; and both match the reference's decode logits."""
    cfg, rcfg, lm, params = _models("codeqwen1.5-7b")
    B, S = 2, 12
    toks = _tokens(cfg, B, S + 1)
    tt = torch.as_tensor(toks)
    cache_a = init_cache(cfg, RT, B, max_len=S + 2, dtype=torch.float32)
    for t in range(S + 1):
        lg_a, cache_a = apply_decode(lm, cfg, RT, tt[:, t:t + 1], cache_a, t)
    apply_lm(lm, cfg, RT, tt[:, :S])
    cache_b = init_cache(cfg, RT, B, max_len=S + 2, dtype=torch.float32)
    for t in range(S):
        _, cache_b = apply_decode(lm, cfg, RT, tt[:, t:t + 1], cache_b, t)
    lg_b, _ = apply_decode(lm, cfg, RT, tt[:, S:S + 1], cache_b, S)
    np.testing.assert_allclose(lg_a.numpy(), lg_b.numpy(), atol=1e-4)
    ref_cache = ref_init_cache(rcfg, REF_RT, B, max_len=S + 2, dtype=jnp.float32)
    for t in range(S + 1):
        ref_lg, ref_cache = ref_apply_decode(params, rcfg, REF_RT, jnp.asarray(toks[:, t:t + 1]),
                                             ref_cache, jnp.int32(t))
    assert _rel(lg_b.numpy(), ref_lg) < 1e-4
    np.testing.assert_allclose(cache_b["stage0"]["b0"]["k"].numpy(),
                               np.asarray(ref_cache["stage0"]["b0"]["k"]), atol=1e-5)


@pytest.mark.parametrize("arch", ["gemma-2b", "codeqwen1.5-7b"])
def test_prefill_fill_attention_branch_matches_reference(arch):
    """apply_attention with a cache and S > 1 writes k/v at [0, S) and runs
    flash attention, as the reference's prefill-fill branch."""
    cfg, rcfg, lm, params = _models(arch)
    B, S, T = 2, 10, 16
    x = np.random.default_rng(2).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    ref_p = jax.tree.map(lambda a: a[0], params["stage0"]["b0"]["attn"])
    kv_shape = (B, cfg.kv_heads, T, cfg.resolved_head_dim)
    ref_cache = {"k": jnp.zeros(kv_shape, jnp.float32), "v": jnp.zeros(kv_shape, jnp.float32),
                 "index": jnp.int32(0)}
    pos = np.arange(S, dtype=np.int32)[None, :]
    want, want_cache = RL.apply_attention(ref_p, jnp.asarray(x), rcfg, REF_RT,
                                          positions=jnp.asarray(pos), cache=ref_cache)
    cache = {"k": torch.zeros(kv_shape), "v": torch.zeros(kv_shape), "index": 0}
    got, got_cache = L.apply_attention(lm.layers[0][0].attn, torch.as_tensor(x), cfg, RT,
                                       positions=torch.as_tensor(pos), cache=cache)
    assert _rel(got.numpy(), want) < 1e-5
    for name in ("k", "v"):
        np.testing.assert_allclose(got_cache[name].numpy(), np.asarray(want_cache[name]),
                                   atol=1e-5)


@pytest.mark.parametrize("arch", DENSE)
def test_param_count_matches_config(arch):
    cfg = get_config(arch).reduced()
    lm = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert sum(p.numel() for p in lm.parameters()) == cfg.total_params()
    tree = interop.numpy_params(cfg, SEED)
    assert sum(a.size for a in jax.tree.leaves(tree)) == cfg.total_params()
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        jax.eval_shape(lambda: __import__("repro.models.model", fromlist=["x"]).init_params(
            ref_config(arch).reduced(), jax.random.PRNGKey(0)))))
    assert want == cfg.total_params()


def test_init_params_draws_from_the_generator():
    cfg = get_config("gemma-2b").reduced()
    a = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    c = init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    assert torch.equal(a.embed, b.embed) and not torch.equal(a.embed, c.embed)
    assert float(a.embed.std()) == pytest.approx(cfg.d_model**-0.5, rel=0.05)
    assert torch.all(a.final_norm.w == 0.0)  # gemma's (1 + w) norm starts at w = 0


@pytest.mark.parametrize("arch", sorted(set(ARCH_IDS) - set(DENSE)))
def test_non_dense_families_raise(arch):
    cfg = get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LM(cfg, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        interop.numpy_params(cfg, SEED)


def test_params_from_jax_rejects_a_wrong_tree():
    cfg = get_config("gemma-2b").reduced()
    tree = interop.numpy_params(cfg, SEED)
    tree["stage0"]["b0"]["attn"]["wq"] = tree["stage0"]["b0"]["attn"]["wq"][:1]
    with pytest.raises(ValueError, match="wq"):
        interop.params_from_jax(tree, cfg, "cpu")
    tree = interop.numpy_params(cfg, SEED)
    tree["lm_head"] = np.zeros((cfg.d_model, cfg.vocab), np.float32)  # gemma ties embeddings
    with pytest.raises(ValueError, match="lm_head"):
        interop.params_from_jax(tree, cfg, "cpu")
