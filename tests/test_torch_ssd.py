"""The port's SSD chunk scan (``repro_torch.kernels``: ``ref.ssd_chunk_plain``,
the CUDA kernel's plain version, and ``ops.ssd_chunks``, what the Mamba block
runs) against the reference's Pallas kernel in interpret mode and its einsum
oracle ``_ssd_chunks_ref``, on numpy-seeded inputs, float32 on the CPU.
Tolerances are the reference's own (``tests/test_kernels.py``): atol 2e-5 /
rtol 2e-4 against the oracle, atol 1e-4 / rtol 1e-3 against the sequential
recurrence. The CUDA kernel itself is held to this plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64 as in the reference's own test runs)
import jax.numpy as jnp
from repro.kernels import ops as ref_ops
from repro.kernels.ssd import ssd_chunk_fwd as ref_ssd_chunk_fwd
from repro.models.mamba import _ssd_chunks_ref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd as port_kernel

TOL = dict(atol=2e-5, rtol=2e-4)
# (B, S, H, P, N, chunk): the reference's two test shapes, the reduced
# engine's 8-token prefill (Q = 8 inside a 64-row tile) and the serving
# shape cut to one sequence and two heads (nc = 2, N = 128).
SHAPES = [(1, 128, 2, 32, 16, 64), (2, 256, 4, 64, 32, 128), (2, 8, 4, 16, 16, 256),
          (1, 512, 2, 64, 128, 256)]


def _inputs(seed, B, S, H, P, N):
    """The reference test's distributions: x ~ N(0, 1), B and C ~ 0.5·N(0, 1),
    da = -softplus(N(0, 1))."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    bm = (0.5 * rng.standard_normal((B, S, N))).astype(np.float32)
    cm = (0.5 * rng.standard_normal((B, S, N))).astype(np.float32)
    da = (-np.logaddexp(rng.standard_normal((B, S, H)), 0.0)).astype(np.float32)
    return x, bm, cm, da


def _t(arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES)
def test_chunk_plain_matches_pallas_kernel(B, S, H, P, N, chunk):
    """y_diag and the chunk states of the plain version against the Pallas
    kernel's, interpreted."""
    arrays = _inputs(B * S + P, B, S, H, P, N)
    Q = min(chunk, S)
    y, states, cum = ref.ssd_chunk_plain(*_t(arrays), Q)
    want_y, want_states = ref_ssd_chunk_fwd(*(jnp.asarray(a) for a in arrays), chunk=Q,
                                            interpret=True)
    assert y.shape == (B, S, H, P) and states.shape == (B, S // Q, H, P, N)
    assert y.dtype == states.dtype == cum.dtype == torch.float32
    # the chunks' cumsum of da, in the reference's order of sums: bit for bit
    want_cum = jnp.cumsum(jnp.asarray(arrays[3]).reshape(B, S // Q, Q, H), axis=2)
    np.testing.assert_array_equal(cum.numpy(), np.asarray(want_cum).reshape(B, S, H))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(states.numpy(), np.asarray(want_states), **TOL)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES)
def test_ssd_chunks_matches_pallas_route_and_oracle(B, S, H, P, N, chunk):
    """ops.ssd_chunks on CPU tensors against the reference's ops.ssd_chunks
    through the interpreted Pallas kernel and against _ssd_chunks_ref; the
    port's copy of the oracle against the reference's."""
    arrays = _inputs(B * S + P, B, S, H, P, N)
    jx = [jnp.asarray(a) for a in arrays]
    before = port_kernel.launches
    y, final = ops.ssd_chunks(*_t(arrays), chunk=chunk)
    assert port_kernel.launches == before  # CPU tensors never reach the kernel
    assert final.shape == (B, H, P, N)
    pallas_y, pallas_final = ref_ops.ssd_chunks(*jx, chunk=chunk, backend="interpret")
    oracle_y, oracle_final = _ssd_chunks_ref(*jx, chunk=chunk)
    for want_y, want_final in ((pallas_y, pallas_final), (oracle_y, oracle_final)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
        np.testing.assert_allclose(final.numpy(), np.asarray(want_final), **TOL)
    port_y, port_final = ref.ssd_chunks_reference(*_t(arrays), chunk)
    np.testing.assert_allclose(port_y.numpy(), np.asarray(oracle_y), **TOL)
    np.testing.assert_allclose(port_final.numpy(), np.asarray(oracle_final), **TOL)


@pytest.mark.parametrize("chunk", [16, 64])
def test_chunked_equals_sequential_recurrence(chunk):
    """As the reference's test: the chunked scan equals the token-by-token
    linear recurrence (ground truth), here through ops.ssd_chunks."""
    B, S, H, P, N = 1, 64, 2, 8, 4
    x, bm, cm, da = _inputs(11, B, S, H, P, N)
    y, final = ops.ssd_chunks(*_t((x, bm, cm, da)), chunk=chunk)
    s = np.zeros((B, H, P, N), np.float32)
    ys = []
    for t in range(S):
        s = np.exp(da[:, t])[..., None, None] * s + np.einsum("bhp,bn->bhpn", x[:, t], bm[:, t])
        ys.append(np.einsum("bhpn,bn->bhp", s, cm[:, t]))
    np.testing.assert_allclose(y.numpy(), np.stack(ys, axis=1), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(final.numpy(), s, atol=1e-4, rtol=1e-3)


def test_backends_on_cpu_give_the_plain_version():
    arrays = _t(_inputs(3, 2, 64, 3, 16, 16))
    auto = ops.ssd_chunks(*arrays, chunk=32)
    reference = ops.ssd_chunks(*arrays, chunk=32, backend="reference")
    for a, b in zip(auto, reference):
        assert torch.equal(a, b)
    y_diag, _, _ = ref.ssd_chunk_plain(*arrays, 32)
    assert y_diag.shape == auto[0].shape
    with pytest.raises(ValueError, match="backend"):
        ops.ssd_chunks(*arrays, chunk=32, backend="interpret")


def test_bf16_inputs_are_cast_to_float32():
    """The wrapper casts its inputs, as the reference's ops.py does."""
    arrays = _t(_inputs(4, 1, 32, 2, 16, 16))
    y, final = ops.ssd_chunks(*(a.to(torch.bfloat16) for a in arrays), chunk=16)
    want_y, want_final = ops.ssd_chunks(*(a.to(torch.bfloat16).float() for a in arrays),
                                        chunk=16)
    assert y.dtype == final.dtype == torch.float32
    assert torch.equal(y, want_y) and torch.equal(final, want_final)


@pytest.mark.parametrize("n", [1, 8, 16, 17, 100, 256, 300, 1000])
def test_cumsum_blocked_is_the_references_cumsum(n):
    """jnp.cumsum on the CPU sums in blocks of 16 (sequential inside a block,
    block totals scanned the same way); cumsum_blocked takes that order, so
    the two agree bit for bit along any axis."""
    da = _inputs(n, 2, n, 3, 16, 16)[3]
    want = np.asarray(jnp.cumsum(jnp.asarray(da), axis=1))
    np.testing.assert_array_equal(ref.cumsum_blocked(torch.as_tensor(da), dim=1).numpy(), want)


@pytest.mark.parametrize("S,chunk", [(300, 256), (12, 8)])
def test_ragged_sequence_raises(S, chunk):
    """S % Q != 0: the reference's reshape fails and its kernel asserts; the
    port raises ValueError and does not pad."""
    arrays = _t(_inputs(5, 1, S, 2, 16, 16))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_chunks(*arrays, chunk=chunk)


def test_kernel_wrapper_refuses_cpu_tensors():
    arrays = _t(_inputs(6, 1, 16, 2, 16, 16))
    before = port_kernel.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_kernel.ssd_chunk_fwd(*arrays, chunk=16)
    assert port_kernel.launches == before


# --- the CUDA kernel's arithmetic, emulated on the CPU -----------------------
# csrc/ssd.cu runs its three products (the scores C Bᵀ, (S ⊙ L) x and the
# states) on the tensor cores in TF32: each float32 operand a is split as hi =
# tf32(a), lo = tf32(a - hi), rounded to nearest with ties away (cvt.rna), and
# lo·hi + hi·lo + hi·hi is summed in float32. The shapes are
# tests/test_torch_gpu.py's for the kernel; the first five are where one TF32
# product alone fails the bar.
GPU_SHAPES = [(4, 512, 24, 64, 128, 256), (1, 128, 2, 32, 16, 64), (2, 256, 4, 64, 32, 128),
              (2, 8, 4, 16, 16, 256), (1, 100, 3, 32, 64, 50), (1, 128, 5, 32, 64, 64),
              (2, 512, 25, 64, 128, 256), (2, 16, 3, 16, 16, 1), (2, 256, 4, 16, 128, 64)]


def _ssd_chunk_tf32(x, bmat, cmat, da, chunk, terms):
    """The kernel's function with its products on TF32 operands: the scores
    once per (batch, chunk), the decay and mask in float32 as the plain
    version, the states as (x ⊙ exp(cum_end - cum))ᵀ B."""
    B, S, H, P = x.shape
    N = bmat.shape[-1]
    Q, nc = chunk, S // chunk
    xc = x.reshape(B, nc, Q, H, P)
    bc, cc = bmat.reshape(B, nc, Q, N), cmat.reshape(B, nc, Q, N)
    cum = ref.cumsum_blocked(da.reshape(B, nc, Q, H), dim=2)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, Q_i, Q_j, H)
    pos = torch.arange(Q)
    tri = (pos[:, None] >= pos[None, :])[:, :, None]
    scores = ref.tf32_einsum("bnis,bnjs->bnij", cc, bc, terms)
    pm = torch.where(tri, scores[..., None] * torch.exp(seg), 0.0)
    y = ref.tf32_einsum("bnijh,bnjhp->bnihp", pm, xc, terms)
    xw = xc * torch.exp(cum[:, :, -1:, :] - cum)[..., None]
    states = ref.tf32_einsum("bnthp,bnts->bnhps", xw, bc, terms)
    return y.reshape(B, S, H, P), states


@pytest.mark.parametrize("B,S,H,P,N,chunk", GPU_SHAPES)
def test_three_tf32_products_meet_the_card_check(B, S, H, P, N, chunk):
    """Three TF32 products per float32 product stay within the card check's
    atol 2e-5 / rtol 2e-4 of the plain version (y_diag and states); one TF32
    product misses it at the first five shapes."""
    x, bm, cm, da = _t(_inputs(B * S + P, B, S, H, P, N))
    Q = min(chunk, S)
    want_y, want_states, _ = ref.ssd_chunk_plain(x, bm, cm, da, Q)
    y, states = _ssd_chunk_tf32(x, bm, cm, da, Q, terms=3)
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), **TOL)
    np.testing.assert_allclose(states.numpy(), want_states.numpy(), **TOL)
    if GPU_SHAPES.index((B, S, H, P, N, chunk)) < 5:
        y1, states1 = _ssd_chunk_tf32(x, bm, cm, da, Q, terms=1)
        outside = [not np.allclose(g.numpy(), w.numpy(), **TOL)
                   for g, w in ((y1, want_y), (states1, want_states))]
        assert any(outside), "one TF32 product was expected to miss the bar"


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """ref.tf32_rna keeps 10 mantissa bits: exact on values that have no
    more, ties away from zero, and at most half a TF32 ulp off elsewhere."""
    exact = torch.tensor([1.0, -1.5, 1.0 + 2.0 ** -10, 3.0 * 2.0 ** -20], dtype=torch.float32)
    assert torch.equal(ref.tf32_rna(exact), exact)
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)], dtype=torch.float32)
    assert ref.tf32_rna(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]
    a = torch.as_tensor(np.random.default_rng(7).standard_normal(10000), dtype=torch.float32)
    assert float(((ref.tf32_rna(a) - a).abs() / a.abs()).max()) <= 2.0 ** -11


def test_ssd_bound_counts_the_least_work_at_the_serving_shape():
    """chip_smoke.ssd_bound_ms at (4, 512, 24, 64, 128, 256): the scores once
    per (batch, chunk), the products at a third of the TF32 tensor rate, the
    elementwise work at the float32 rate, against the bytes."""
    from torch_scripts import chip_smoke as smoke

    B, S, H, P, N, Q = 4, 512, 24, 64, 128, 256
    chunks, pairs = B * S // Q, Q * (Q + 1) // 2
    products = chunks * pairs * 2 * N + chunks * H * (pairs * 2 * P + 2 * Q * P * N)
    elementwise = chunks * H * (3 * pairs + Q * (2 + min(N, P)) + Q)
    assert products == 1_681_129_472 and elementwise == 22_241_280
    ms, bound_by = smoke.ssd_bound_ms(B, S, H, P, N, Q)
    want = 1e3 * (products / (495e12 / 3) + elementwise / 67e12)
    assert bound_by == "operations" and ms == pytest.approx(want, rel=1e-12)
    n_bytes = 4 * (2 * B * S * H * P + 2 * B * S * N + 2 * B * S * H + chunks * H * P * N)
    t_bytes = 1e3 * n_bytes / 3.35e12
    assert t_bytes == pytest.approx(0.0101, abs=5e-5) and t_bytes < ms
    # the scores do not scale with the heads: two more heads add only their own work
    more, _ = smoke.ssd_bound_ms(B, S, H + 2, P, N, Q)
    per_head = chunks * (pairs * 2 * P + 2 * Q * P * N) / (495e12 / 3) \
        + chunks * (3 * pairs + Q * (2 + min(N, P)) + Q) / 67e12
    assert more - ms == pytest.approx(1e3 * 2 * per_head, rel=1e-9)


# --- gradients: the SSD chunk step's backward (ref.ssd_chunk_plain recomputed
# under autograd) and the inter-chunk recurrence's, through ops.ssd_chunks ---
GRAD_SHAPES = [(1, 128, 2, 32, 16, 64), (2, 256, 4, 64, 32, 128), (1, 512, 2, 16, 16, 256)]


@pytest.mark.parametrize("B,S,H,P,N,chunk", GRAD_SHAPES)
def test_ssd_chunks_grads_match_reference(B, S, H, P, N, chunk):
    """Gradients of y and the final state, summed with fixed numpy weights,
    through ops.ssd_chunks against jax.grad of _ssd_chunks_ref: within 2e-4
    of each input's max |grad|. The first two shapes are the reference's
    test shapes; the third's decays (chunk 256) overflow exp above the
    diagonal, where the gradient must stay finite. Prints the gaps (-s)."""
    import jax

    arrays = _inputs(B * S + P, B, S, H, P, N)
    rng = np.random.default_rng(99)
    wy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    ws = rng.standard_normal((B, H, P, N)).astype(np.float32)

    def ref_loss(*a):
        y, s = _ssd_chunks_ref(*a, chunk=chunk)
        return (y * wy).sum() + (s * ws).sum()

    want = jax.grad(ref_loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in arrays))
    t = [torch.tensor(a, requires_grad=True) for a in arrays]
    before = port_kernel.launches
    y, final = ops.ssd_chunks(*t, chunk=chunk)
    ((y * torch.as_tensor(wy)).sum() + (final * torch.as_tensor(ws)).sum()).backward()
    assert port_kernel.launches == before
    gaps = {}
    for name, got, w in zip(("x", "B", "C", "da"), t, want):
        w = np.asarray(w)
        assert np.isfinite(got.grad.numpy()).all(), name
        gaps[name] = float(np.max(np.abs(got.grad.numpy() - w)) / np.max(np.abs(w)))
        assert gaps[name] < 2e-4, (name, gaps[name])
    print(f"ssd grad gaps {(B, S, H, P, N, chunk)}: {gaps}")


def test_chunk_step_backward_is_the_plain_versions_gradient():
    """SSDChunk's backward equals autograd through ssd_chunk_plain itself
    (bit for bit: it is that recompute), gradients reaching da also through
    the cumsum output."""
    arrays = _inputs(21, 2, 64, 3, 16, 16)
    rng = np.random.default_rng(22)
    outs_w = [torch.as_tensor(rng.standard_normal(s).astype(np.float32))
              for s in ((2, 64, 3, 16), (2, 4, 3, 16, 16), (2, 64, 3))]
    grads = []
    for fn in (lambda *a: ops.SSDChunk.apply(*a, 16, "auto"),
               lambda *a: ref.ssd_chunk_plain(*a, 16)):
        t = [torch.tensor(a, requires_grad=True) for a in arrays]
        sum((o * w).sum() for o, w in zip(fn(*t), outs_w)).backward()
        grads.append([a.grad for a in t])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
