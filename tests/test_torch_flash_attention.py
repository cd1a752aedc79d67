"""The port's flash-attention plain version (``repro_torch.kernels.ref.
flash_attention_plain``, what ``ops.flash_attention`` runs on CPU tensors)
against the reference's Pallas kernel in interpret mode and its naive oracle,
on numpy-seeded inputs. Tolerances are the reference's own
(``tests/test_kernels.py``): 2e-5 in float32, 3e-2 in bfloat16. The CUDA
kernel itself is held to this plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``); the arithmetic of its bf16
route (P split into two bf16 terms before P·V) is checked here against that
plain version and the Pallas kernel."""
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
