"""The port's model against the reference's in bf16 compute: reduced
gemma-2b, minitron-4b and mamba2-130m on the same ``interop.numpy_params``
weights (float32, cast to bf16 in the layers by both), 2 x 64 tokens from a
seeded NumPy generator, the plain attention and SSD routes of both
(``attn_backend="reference"``), CPU. Bar: max |Δlogit| <= 3e-2 · max
|logit| (the reference's bf16 bar, ``tests/test_kernels.py``) and the top-1
token equal at >= 95 % of the positions. The two packages round the same
bf16 products in different places (the reference's bf16 ``silu``, its
oracle's bf16 rounding of the softmax weights), so bf16 logits do not agree
to the float32 tests' 1e-4."""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64 as in the reference's own test runs)
import jax
import jax.numpy as jnp
from repro.configs import get_config as ref_config
from repro.models import layers as RL
from repro.models.model import apply_lm as ref_apply_lm
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models.layers import Runtime
from repro_torch.models.model import apply_lm

ARCHS = ("gemma-2b", "minitron-4b", "mamba2-130m")
B, S, SEED = 2, 64, 0
BAR = 3e-2  # max |Δlogit| / max |logit|, the reference's bf16 bar
TOP1 = 0.95  # share of positions whose top-1 token agrees


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _logits(arch):
    """(port's, reference's) bf16-compute logits as float64 NumPy arrays."""
    cfg, rcfg = get_config(arch).reduced(), ref_config(arch).reduced()
    tree = interop.numpy_params(cfg, SEED)
    toks = np.random.default_rng(SEED + 1).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    lm = interop.params_from_jax(tree, cfg, "cpu")
    with torch.no_grad():
        got, _ = apply_lm(lm, cfg, Runtime("cpu", torch.bfloat16, "reference"),
                          torch.as_tensor(toks))
    ref_rt = RL.Runtime(mesh=None, data_axes=("data",), compute_dtype=jnp.bfloat16,
                        attn_backend="reference")
    want, _ = ref_apply_lm(jax.tree.map(jnp.asarray, tree), rcfg, ref_rt, jnp.asarray(toks))
    return (got.to(torch.float64).numpy(), np.asarray(want.astype(jnp.float32), np.float64))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_match_reference(arch):
    got, want = _logits(arch)
    assert got.shape == want.shape == (B, S, get_config(arch).reduced().vocab)
    assert np.all(np.isfinite(got))
    gap = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    top1 = float(np.mean(np.argmax(got, -1) == np.argmax(want, -1)))
    print(f"{arch}: max |dlogit| / max |logit| = {gap:.3e}, top-1 agreement {top1:.4f}")
    assert gap <= BAR, gap
    assert top1 >= TOP1, top1
