"""The port's model (``repro_torch.models``, all ten architectures) against
the reference's (``repro.models``) on the same weights:
``interop.numpy_params`` draws a tree in the reference's layout,
``params_from_jax`` loads it into the port's ``LM``. Reduced configurations,
float32 compute, CPU (the plain versions of the flash and SSD chunk kernels).
Bars as ``tests/test_models.py``: logits within 1e-4 of the reference
relative to their max |logit|, decode equal to the full forward within
1e-4; the MoE load-balance aux within rel 1e-6 of the reference's. The vlm
and audio families get numpy-drawn ``patches`` / ``frames`` shaped as the
reference's tests shape them."""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64 as in the reference's own test runs)
import jax
import jax.numpy as jnp
from repro.configs import get_config as ref_config
from repro.models import layers as RL
from repro.models import mamba as RMB
from repro.models.model import apply_decode as ref_apply_decode
from repro.models.model import apply_lm as ref_apply_lm
from repro.models.model import init_cache as ref_init_cache
from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import layers as L
from repro_torch.models import mamba as MB
from repro_torch.models.layers import Runtime
from repro_torch.models.model import (LM, _encode_memory, apply_decode, apply_lm, init_cache,
                                      init_params)

PORTED = list(ARCH_IDS)


@pytest.fixture(autouse=True)
def _forward_only():
    """The port's parameters are trainable: these forward checks run without
    recording an autograd graph (as the serving entry points do)."""
    with torch.no_grad():
        yield
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


def _extra(cfg, B, S, seed=2):
    """``patches`` (vlm) or ``frames`` (audio) as tests/test_models.py shapes
    them, from numpy; {} for the other families."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"patches": rng.standard_normal((B, cfg.n_patches, cfg.d_vision)).astype(np.float32)}
    if cfg.family == "audio":
        F = max(S // cfg.enc_frames_ratio, 4)
        return {"frames": rng.standard_normal((B, F, cfg.d_model)).astype(np.float32)}
    return {}


def _jnp(extra):
    return {k: jnp.asarray(v) for k, v in extra.items()}


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("arch", PORTED)
def test_apply_lm_matches_reference(arch):
    cfg, rcfg, lm, params = _models(arch)
    toks = _tokens(cfg, 2, 32)
    extra = _extra(cfg, 2, 32)
    want, want_aux = ref_apply_lm(params, rcfg, REF_RT, jnp.asarray(toks), _jnp(extra))
    got, aux = apply_lm(lm, cfg, RT, torch.as_tensor(toks), extra)
    assert got.shape == (2, 32, cfg.vocab) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < 1e-4
    assert aux.dtype == torch.float32
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux))
    assert (float(aux) > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("arch", PORTED)
def test_decode_matches_full_forward(arch):
    """Step by step, the decode equals the full forward; for vlm and audio
    (patches / frames passed at every step) it also equals the reference's
    step by step decode."""
    cfg, rcfg, lm, params = _models(arch)
    B, S = 2, 16
    toks = torch.as_tensor(_tokens(cfg, B, S))
    extra = _extra(cfg, B, S)
    full, _ = apply_lm(lm, cfg, RT, toks, extra)
    cache = init_cache(cfg, RT, B, max_len=S, dtype=torch.float32)
    steps = []
    for t in range(S):
        lg, cache = apply_decode(lm, cfg, RT, toks[:, t:t + 1], cache, t, extra)
        steps.append(lg[:, 0])
    steps = torch.stack(steps, dim=1).numpy()
    assert _rel(steps, full.numpy()) < 1e-4
    if extra:
        ref_cache = ref_init_cache(rcfg, REF_RT, B, max_len=S, dtype=jnp.float32)
        for t in range(S):
            ref_lg, ref_cache = ref_apply_decode(params, rcfg, REF_RT,
                                                 jnp.asarray(toks[:, t:t + 1].numpy()),
                                                 ref_cache, jnp.int32(t), _jnp(extra))
            assert _rel(steps[:, t], np.asarray(ref_lg)[:, 0]) < 1e-4, t
    for blk in cache["stage0"].values():
        if "ssm" in blk:  # a Mamba cache has no index; its SSM state is float32
            assert "index" not in blk and blk["ssm"].dtype == torch.float32
        else:
            assert torch.all(blk["index"] == S - 1)


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


def realized_params(cfg):
    """The reference's realized parameter count: ``total_params()`` leaves
    out each Mamba block's ``conv_b`` (Ch) and ``dt_bias`` (nh)
    (``configs/base.py::_mamba_params``; the reference's own test accepts
    that at rel 0.02), so add them back."""
    if cfg.mamba is None:
        return cfg.total_params()
    m = cfg.mamba
    d_in, nh = m.d_inner(cfg.d_model), m.n_heads(cfg.d_model)
    n_mamba = sum(st.repeat for st in cfg.stages() for kind, _ in st.blocks if kind == "mamba")
    return cfg.total_params() + n_mamba * (d_in + 2 * m.d_state + nh)


@pytest.mark.parametrize("arch", PORTED)
def test_param_count_matches_config(arch):
    cfg = get_config(arch).reduced()
    want = realized_params(cfg)
    lm = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert sum(p.numel() for p in lm.parameters()) == want
    tree = interop.numpy_params(cfg, SEED)
    assert sum(a.size for a in jax.tree.leaves(tree)) == want
    ref_tree = jax.eval_shape(lambda: __import__("repro.models.model", fromlist=["x"])
                              .init_params(ref_config(arch).reduced(), jax.random.PRNGKey(0)))
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(ref_tree)) == want
    assert jax.tree.structure(ref_tree) == jax.tree.structure(tree)


def test_mamba_param_count_at_full_width():
    """mamba2-130m at full width: 128,983,488 realized leaves, 43,584 =
    24 x (1792 + 24) more than total_params()."""
    cfg = get_config("mamba2-130m")
    assert cfg.total_params() == 128_939_904
    assert realized_params(cfg) == 128_983_488
    lm = LM(cfg, "meta")
    assert sum(p.numel() for p in lm.parameters()) == realized_params(cfg)


@pytest.mark.parametrize("with_cache", [False, True])
def test_mamba_block_matches_reference(with_cache):
    """apply_mamba against the reference's at S = 256 with chunk 64 (nc = 4,
    so the inter-chunk recurrence runs): the no-cache branch, and the
    prefill-fill branch with the conv and SSM states it leaves in the
    cache."""
    cfg, rcfg, lm, params = _models("mamba2-130m")
    m = cfg.mamba
    B, S = 2, 256
    x = np.random.default_rng(3).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    ref_p = jax.tree.map(lambda a: a[1], params["stage0"]["b0"]["mamba"])
    d_in, nh = m.d_inner(cfg.d_model), m.n_heads(cfg.d_model)
    conv_shape = (B, m.d_conv - 1, d_in + 2 * m.d_state)
    ssm_shape = (B, nh, m.head_dim, m.d_state)
    ref_cache = cache = None
    if with_cache:
        ref_cache = {"conv": jnp.zeros(conv_shape, jnp.float32),
                     "ssm": jnp.zeros(ssm_shape, jnp.float32)}
        cache = {"conv": torch.zeros(conv_shape), "ssm": torch.zeros(ssm_shape)}
    want, want_cache = RMB.apply_mamba(ref_p, jnp.asarray(x), rcfg, REF_RT, cache=ref_cache,
                                       chunk=64)
    got, got_cache = MB.apply_mamba(lm.layers[1][0].mamba, torch.as_tensor(x), cfg, RT,
                                    cache=cache, chunk=64)
    assert got.shape == (B, S, cfg.d_model)
    assert _rel(got.numpy(), want) < 1e-5
    if not with_cache:
        assert got_cache is None and want_cache is None
        return
    assert got_cache is cache  # written in place
    assert _rel(cache["conv"].numpy(), want_cache["conv"]) < 1e-5
    assert _rel(cache["ssm"].numpy(), want_cache["ssm"]) < 1e-5


def test_mamba_init_params_constants():
    """init_params keeps the reference's Mamba constants and float32 leaves
    whatever the model dtype."""
    cfg = get_config("mamba2-130m").reduced()
    lm = init_params(cfg, torch.Generator().manual_seed(0), torch.bfloat16, device="cpu")
    mb = lm.layers[0][0].mamba
    for name in ("a_log", "d_skip", "dt_bias"):
        assert getattr(mb, name).dtype == torch.float32
    assert torch.all(mb.a_log == 0) and torch.all(mb.dt_bias == 0) and torch.all(mb.conv_b == 0)
    assert torch.all(mb.d_skip == 1) and torch.all(mb.norm_w == 1)
    assert mb.w_in.dtype == torch.bfloat16
    assert float(mb.conv_w.float().std()) == pytest.approx(0.1, rel=0.1)
    assert float(mb.w_out.float().std()) == pytest.approx(mb.w_out.shape[0] ** -0.5, rel=0.1)
    cache = init_cache(cfg, RT, 2, 8, dtype=torch.bfloat16)["stage0"]["b0"]
    assert cache["conv"].dtype == torch.bfloat16 and cache["ssm"].dtype == torch.float32


def test_init_params_draws_from_the_generator():
    cfg = get_config("gemma-2b").reduced()
    a = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    c = init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    assert torch.equal(a.embed, b.embed) and not torch.equal(a.embed, c.embed)
    assert float(a.embed.std()) == pytest.approx(cfg.d_model**-0.5, rel=0.05)
    assert torch.all(a.final_norm.w == 0.0)  # gemma's (1 + w) norm starts at w = 0


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "seamless-m4t-large-v2"])
def test_memoised_memory_gives_the_same_logits(arch):
    """A precomputed ``memory`` (the serving path's memoised encoder output
    or patch projection) short-circuits ``_encode_memory``: the same logits
    as passing ``patches`` / ``frames``, in prefill and in a decode step."""
    cfg, rcfg, lm, params = _models(arch)
    B, S = 2, 12
    toks = torch.as_tensor(_tokens(cfg, B, S))
    extra = _extra(cfg, B, S)
    memory = _encode_memory(lm, cfg, RT, extra)
    F = cfg.n_patches if cfg.family == "vlm" else extra["frames"].shape[1]
    assert memory.shape == (B, F, cfg.d_model)
    assert torch.equal(apply_lm(lm, cfg, RT, toks, extra)[0],
                       apply_lm(lm, cfg, RT, toks, {"memory": memory})[0])
    steps = {}
    for name, ex in (("raw", extra), ("memory", {"memory": memory.numpy()})):
        cache = init_cache(cfg, RT, B, max_len=S, dtype=torch.float32)
        for t in range(3):
            steps[name], cache = apply_decode(lm, cfg, RT, toks[:, t:t + 1], cache, t, ex)
    assert torch.equal(steps["raw"], steps["memory"])
    from repro.models.model import _encode_memory as ref_encode_memory

    want = ref_encode_memory(params, rcfg, REF_RT, _jnp(extra))
    assert _rel(memory.numpy(), want) < 1e-5


def test_moe_init_params_scales_and_router_dtype():
    """init_params draws the MoE leaves at the reference's scales (experts'
    w_down at d_ff_expert^-0.5, not d_ff^-0.5) and keeps the router float32
    in a bf16 model; vision_proj at d_vision^-0.5."""
    cfg = get_config("moonshot-v1-16b-a3b").reduced(d_ff=1024)
    lm = init_params(cfg, torch.Generator().manual_seed(0), torch.bfloat16, device="cpu")
    moe = lm.layers[0][1].moe
    assert moe.router.dtype == torch.float32 and moe.w_down.dtype == torch.bfloat16
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    for name, scale in (("router", d**-0.5), ("w_gate", d**-0.5), ("w_up", d**-0.5),
                        ("w_down", f**-0.5)):
        assert float(getattr(moe, name).float().std()) == pytest.approx(scale, rel=0.05), name
    tree = interop.numpy_params(cfg, SEED)
    assert float(tree["stage0"]["b1"]["moe"]["w_down"].std()) == pytest.approx(f**-0.5, rel=0.05)
    loaded = interop.params_from_jax(tree, cfg, "cpu", torch.bfloat16)
    assert loaded.layers[0][1].moe.router.dtype == torch.float32
    vcfg = get_config("llama-3.2-vision-90b").reduced()
    vlm = init_params(vcfg, torch.Generator().manual_seed(0), device="cpu")
    assert float(vlm.vision_proj.std()) == pytest.approx(vcfg.d_vision**-0.5, rel=0.1)


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
