"""The port's flash-attention plain version (``repro_torch.kernels.ref.
flash_attention_plain``, what ``ops.flash_attention`` runs on CPU tensors)
against the reference's Pallas kernel in interpret mode and its naive oracle,
on numpy-seeded inputs. Tolerances are the reference's own
(``tests/test_kernels.py``): 2e-5 in float32, 3e-2 in bfloat16. The CUDA
kernel itself is held to this plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``); the arithmetic of its bf16
route (P split into two bf16 terms before P·V) and of its float32 route (both
products in three TF32 products each) is checked here against that plain
version (and the bf16 route against the Pallas kernel)."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64 as in the reference's own test runs)
import jax.numpy as jnp
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.kernels import flash_attention as port_kernel
from repro_torch.kernels import ops, ref


def _qkv(seed, B, Sq, Skv, KV, G, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, KV, G, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, hd)).astype(np.float32))


def _port(q, k, v, causal, dtype=torch.float32):
    t = [torch.as_tensor(a).to(dtype) for a in (q, k, v)]
    return ops.flash_attention(*t, causal=causal).float().numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize(
    "B,Sq,KV,G,hd",
    [(1, 128, 1, 2, 64), (2, 256, 2, 2, 64), (1, 256, 4, 1, 128), (1, 128, 1, 8, 256)],
)
def test_plain_matches_pallas_interpret_and_naive(B, Sq, KV, G, hd, causal):
    q, k, v = _qkv(B * Sq + hd, B, Sq, Sq, KV, G, hd)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    out = _port(q, k, v, causal)
    pallas = np.asarray(ref_ops.flash_attention(jq, jk, jv, causal=causal, backend="interpret"))
    naive = np.asarray(ref_ref.attention_naive(jq, jk, jv, causal=causal))
    np.testing.assert_allclose(out, pallas, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out, naive, atol=2e-5, rtol=2e-5)
    port_naive = ref.attention_naive(*(torch.as_tensor(a) for a in (q, k, v)), causal).numpy()
    np.testing.assert_allclose(port_naive, naive, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_dtype_sweep(dtype):
    """As the reference's dtype sweep: (2, 192, KV 2, G 3, 64), causal; bf16
    inputs in, q's dtype out, against the naive oracle on the same inputs."""
    q, k, v = _qkv(7, 2, 192, 192, 2, 3, 64)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.as_tensor(a).to(tdt) for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=True)
    assert out.dtype == tdt
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype)) for t in (tq, tk, tv))
    want = np.asarray(ref_ref.attention_naive(jq, jk, jv, True), np.float32)
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(out.float().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_nonsquare_and_padding(causal):
    """Sq != Skv, neither a multiple of the 32-row/32-key tiles."""
    q, k, v = _qkv(3, 1, 70, 130, 2, 2, 32)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    out = _port(q, k, v, causal)
    want = np.asarray(ref_ref.flash_attention(jq, jk, jv, causal, 32, 64))
    np.testing.assert_allclose(out, want, atol=2e-5, rtol=2e-5)
    if not causal:
        naive = np.asarray(ref_ref.attention_naive(jq, jk, jv, False))
        np.testing.assert_allclose(out, naive, atol=2e-5, rtol=2e-5)


def test_fully_masked_rows_give_zero_not_nan():
    """The 26 padded query rows of a 70-row input are masked against every
    key (m stays -inf through every kv tile): the isfinite guards make them
    0, never NaN, and the live rows are untouched by them."""
    q, k, v = _qkv(4, 1, 70, 130, 2, 2, 32)
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    padded = ref._flash_blocks(tq, tk, tv, True, 32, 32)  # (B, KV, G, 96, hd)
    assert padded.shape[3] == 96
    assert not torch.isnan(padded).any()
    assert torch.all(padded[:, :, :, 70:] == 0)
    live = padded[:, :, :, :70].permute(0, 3, 1, 2, 4).numpy()
    np.testing.assert_allclose(live, _port(q, k, v, True), rtol=0, atol=0)


def test_dispatch_on_cpu_runs_the_plain_version():
    q, k, v = (torch.as_tensor(a) for a in _qkv(5, 1, 40, 40, 1, 2, 32))
    before = port_kernel.launches
    auto = ops.flash_attention(q, k, v, causal=True, backend="auto")
    plain = ref.flash_attention_plain(q, k, v, True)
    assert port_kernel.launches == before
    assert torch.equal(auto, plain)
    assert torch.equal(ops.flash_attention(q, k, v, causal=True, backend="reference"), plain)
    with pytest.raises(ValueError, match="backend"):
        ops.flash_attention(q, k, v, causal=True, backend="pallas")


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.as_tensor(a) for a in _qkv(6, 1, 8, 8, 1, 1, 32))
    with pytest.raises(ValueError, match="CUDA"):
        port_kernel.flash_attention_fwd(q, k, v, causal=True)


def _split_p_blocks(q, k, v, causal: bool, kb: int = 64):
    """The plain version's streaming softmax over tiles of ``kb`` keys (the
    bf16 CUDA kernel's 64), with P replaced by bf16(P) + bf16(P - bf16(P))
    before P·V, as the kernel feeds P to the bf16 tensor cores in two terms.
    Returns q's dtype in q's layout."""
    B, Sq, KV, G, hd = q.shape
    Skv = k.shape[1]
    qf, kf, vf = (t.float() for t in (q, k, v))
    q_pos = torch.arange(Sq)[:, None]
    m = torch.full((B, KV, G, Sq), -torch.inf)
    l = torch.zeros((B, KV, G, Sq))
    acc = torch.zeros((B, KV, G, Sq, hd))
    for k_start in range(0, Skv, kb):
        kt, vt = kf[:, k_start:k_start + kb], vf[:, k_start:k_start + kb]
        s = torch.einsum("bqkgh,btkh->bkgqt", qf, kt) * hd**-0.5
        k_pos = torch.arange(k_start, k_start + kt.shape[1])[None, :]
        mask = k_pos < Skv
        if causal:
            mask = mask & (q_pos >= k_pos)
        s = torch.where(mask, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]), 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(dim=-1)
        p_hi = p.to(torch.bfloat16).float()
        p_lo = (p - p_hi).to(torch.bfloat16).float()
        acc = (acc * corr[..., None] + torch.einsum("bkgqt,btkh->bkgqh", p_hi, vt)
               + torch.einsum("bkgqt,btkh->bkgqh", p_lo, vt))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


@pytest.mark.parametrize("B,Sq,KV,G,hd", [(2, 128, 1, 8, 64), (1, 96, 2, 2, 256)])
def test_split_p_bf16_meets_the_card_check(B, Sq, KV, G, hd):
    """The bf16 kernel's arithmetic passes the card's unchanged bf16 check
    against the plain version (each element within one bf16 ulp, fewer than
    1 % differing) and the reference's 3e-2 against the Pallas kernel."""
    tq, tk, tv = (torch.as_tensor(a).to(torch.bfloat16) for a in _qkv(B * Sq + hd, B, Sq, Sq, KV,
                                                                       G, hd))
    split = _split_p_blocks(tq, tk, tv, True).float().numpy()
    plain = ref.flash_attention_plain(tq, tk, tv, True).float().numpy()
    np.testing.assert_allclose(split, plain, atol=2e-5, rtol=2.0 ** -7)
    assert np.mean(split != plain) < 0.01
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (tq, tk, tv))
    pallas = np.asarray(ref_ops.flash_attention(jq, jk, jv, causal=True, backend="interpret"),
                        np.float32)
    np.testing.assert_allclose(split, pallas, atol=3e-2, rtol=3e-2)


# --- the float32 CUDA kernel's arithmetic, emulated on the CPU ---------------
# csrc/flash_attention.cu runs both float32 products (S = Q Kᵀ and P V) on the
# tensor cores in TF32: each float32 operand x split as hi = tf32(x), lo =
# tf32(x - hi) (ref.tf32_rna), and lo·hi + hi·lo + hi·hi summed in float32;
# the softmax stays in float32. The shapes are chip_smoke.py's float32 ones.
F32_SHAPES = [(4, 512, 512, 1, 8, 256, True), (1, 256, 256, 4, 1, 128, True),
              (1, 70, 130, 2, 2, 32, False), (2, 192, 192, 2, 3, 64, True)]


def _flash_tf32(q, k, v, causal: bool, terms: int):
    """Attention with both products on TF32 operands (``terms`` products
    each, ref.tf32_einsum), the masks, guards and finalisation of the plain
    version, in q's (B, Sq, KV, G, hd) layout."""
    B, Sq, KV, G, hd = q.shape
    Skv = k.shape[1]
    s = ref.tf32_einsum("bqkgh,btkh->bkgqt", q, k, terms) * hd**-0.5
    k_pos = torch.arange(Skv)[None, :]
    if causal:
        s = torch.where(torch.arange(Sq)[:, None] >= k_pos, s, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(torch.isfinite(s), torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)),
                    0.0)
    out = ref.tf32_einsum("bkgqt,btkh->bkgqh", p, v, terms)
    out = out / torch.clamp(p.sum(dim=-1), min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4)


@pytest.mark.parametrize("B,Sq,Skv,KV,G,hd,causal", F32_SHAPES)
def test_three_tf32_products_meet_the_f32_card_check(B, Sq, Skv, KV, G, hd, causal):
    """Three TF32 products per float32 product keep the float32 kernel within
    the card check's atol = rtol = 2e-5 of the plain version (chip_smoke.py's
    inputs); one TF32 product misses it."""
    rng = np.random.default_rng(0 + B * Sq + hd)  # chip_smoke.check_flash's seed
    q, k, v = (torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
               for shape in ((B, Sq, KV, G, hd), (B, Skv, KV, hd), (B, Skv, KV, hd)))
    want = ref.flash_attention_plain(q, k, v, causal).numpy()
    np.testing.assert_allclose(_flash_tf32(q, k, v, causal, terms=3).numpy(), want,
                               atol=2e-5, rtol=2e-5)
    one = _flash_tf32(q, k, v, causal, terms=1).numpy()
    assert not np.allclose(one, want, atol=2e-5, rtol=2e-5), \
        "one TF32 product was expected to miss the bar"


def test_flash_f32_bound_counts_the_least_work_at_the_serving_shape():
    """chip_smoke.flash_bound_ms in float32 at (4, 512, 512, 1, 8, 256)
    causal: the products at a third of the TF32 tensor rate plus the
    softmax's five operations a score at the float32 rate, against the
    bytes; bf16 keeps its tensor-core count."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    B, S, KV, G, hd = 4, 512, 1, 8, 256
    products = 4 * B * KV * G * S * S * hd // 2
    softmax = 5 * B * KV * G * S * S // 2
    assert products == 4_294_967_296 and softmax == 20_971_520
    ms, bound_by = smoke.flash_bound_ms(B, S, S, KV, G, hd, True, torch.float32)
    assert bound_by == "operations"
    assert ms == pytest.approx(1e3 * (products / (495e12 / 3) + softmax / 67e12), rel=1e-12)
    assert ms == pytest.approx(0.02634, abs=5e-5)
    t_bytes = 1e3 * 4 * (2 * B * S * KV * G * hd + 2 * B * S * KV * hd) / 3.35e12
    assert t_bytes == pytest.approx(0.01127, abs=5e-5) and t_bytes < ms
    bf16, by = smoke.flash_bound_ms(B, S, S, KV, G, hd, True, torch.bfloat16)
    assert by == "bytes" and bf16 == pytest.approx(t_bytes / 2, rel=1e-12)


# --- gradients: ops.flash_attention's backward (ref.flash_attention_bwd) -----
# against jax.grad of the reference's custom_vjp (repro/kernels/ref.py), the
# bar of tests/test_kernels.py::test_flash_custom_vjp_grads
GRAD_CASES = [(1, 96, 96, 2, 2, 32, True, 32, 32), (1, 70, 130, 2, 2, 32, False, 32, 32),
              (1, 70, 130, 2, 2, 32, True, 32, 64), (1, 96, 96, 2, 2, 32, True, 512, 1024),
              (1, 70, 130, 2, 2, 32, False, 512, 1024)]


@pytest.mark.parametrize("B,Sq,Skv,KV,G,hd,causal,qb,kb", GRAD_CASES)
def test_flash_grads_match_reference_custom_vjp(B, Sq, Skv, KV, G, hd, causal, qb, kb):
    """Gradients of sum(out²) through the port's FlashAttention (the plain
    forward on CPU tensors, the blockwise backward at blocks qb / kb) against
    jax.grad of ref.flash_attention at the same blocks: atol 5e-5, rtol
    5e-4. The last two cases are the default blocks, which ops.flash_attention
    uses."""
    import jax

    q, k, v = _qkv(11 + Sq, B, Sq, Skv, KV, G, hd)
    want = jax.grad(lambda q, k, v: (ref_ref.flash_attention(q, k, v, causal, qb, kb) ** 2).sum(),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    t = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    if (qb, kb) == (ref.DEFAULT_QB, ref.DEFAULT_KB):
        out = ops.flash_attention(*t, causal=causal)
    else:
        out = ops.FlashAttention.apply(*t, causal, "auto", qb, kb)
    (out ** 2).sum().backward()
    for got, w in zip(t, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), atol=5e-5, rtol=5e-4)


@pytest.mark.parametrize("B,Sq,Skv,KV,G,hd,causal,qb,kb", GRAD_CASES[:3])
def test_flash_lse_matches_reference_streaming(B, Sq, Skv, KV, G, hd, causal, qb, kb):
    """flash_lse, the backward's recomputed log-sum-exp, against the
    reference's _fwd_streaming (its forward's residual) at the same blocks."""
    q, k, v = _qkv(12 + Sq, B, Sq, Skv, KV, G, hd)
    _, want = ref_ref._fwd_streaming(*(jnp.asarray(a) for a in (q, k, v)), causal, qb, kb)
    got = ref.flash_lse(torch.as_tensor(q), torch.as_tensor(k), causal, qb, kb)
    assert got.shape == (B, KV, G, Sq) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_grads_match_naive_autograd(dtype):
    """The backward against autograd through the naive oracle, at the
    training shape's layout cut down (MQA, G 8, hd 256, causal): the
    reference's bars (5e-5 / 5e-4 in float32, 3e-2 in bfloat16), gradients
    in the inputs' dtype."""
    tdt = getattr(torch, dtype)
    q, k, v = (torch.as_tensor(a).to(tdt) for a in _qkv(13, 2, 64, 64, 1, 8, 256))
    dout = torch.as_tensor(np.random.default_rng(14).standard_normal(q.shape)).to(tdt)
    grads = {}
    for name, fn in (("flash", ops.flash_attention), ("naive", ref.attention_naive)):
        t = [a.clone().requires_grad_() for a in (q, k, v)]
        out = fn(*t, causal=True)
        out.float().backward(dout.float())
        grads[name] = [a.grad for a in t]
    tol = dict(atol=3e-2, rtol=3e-2) if dtype == "bfloat16" else dict(atol=5e-5, rtol=5e-4)
    for got, want in zip(grads["flash"], grads["naive"]):
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), **tol)


def test_flash_backward_launches_no_kernel_on_cpu():
    """On CPU tensors forward and backward are plain torch: no launch."""
    q, k, v = (torch.tensor(a, requires_grad=True) for a in _qkv(15, 1, 40, 40, 1, 2, 32))
    before = port_kernel.launches
    ops.flash_attention(q, k, v, causal=True).sum().backward()
    assert port_kernel.launches == before
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))
