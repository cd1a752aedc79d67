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
