"""The plain references against the port at small sizes on the CPU, in
float32 with the kernels' plain versions (``attn_backend="reference"``): a
test may import both. The reference alone imports nothing of the port."""
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent / "src"), str(HERE / "tests")]

import program  # noqa: E402
import tiny  # noqa: E402
import weights as W  # noqa: E402
from reference import mamba2, moe_decoder, plain  # noqa: E402

F32 = torch.float32
SEED = 2**32 + 3


def _port(prog, dtype=F32, requires_grad=False, seed=SEED):
    ref = moe_decoder if prog["family"] == "moe" else mamba2
    w = W.make(ref.param_specs(prog, dtype), seed, "cpu")
    cfg = program.model_config(prog)
    return w, cfg, program.model(cfg, w, dtype, requires_grad)


def _prefill(cfg, lm, tokens, record=False):
    from repro_torch.models import moe
    from repro_torch.serve.step import make_prefill_step

    step = make_prefill_step(cfg, program.runtime("cpu", "float32", "reference"))
    if not record:
        return step(lm, {"tokens": tokens}), None
    with moe.recording_routes() as ids:
        out = step(lm, {"tokens": tokens})
    return out, list(ids)


def _tokens(B, S, V, seed=0):
    return torch.randint(0, V, (B, S), generator=torch.Generator().manual_seed(seed))


def test_weights_are_the_seeds():
    specs = moe_decoder.param_specs(tiny.MOE, torch.bfloat16)
    a, b = W.make(specs, SEED, "cpu"), W.make(specs, SEED, "cpu")
    c = W.make(specs, SEED + 1, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["embed"], c["embed"])
    assert a["layers.0.1.moe.router"].dtype == F32
    assert float(a["layers.0.0.norm.w"].float().mean()) == 1.0
    assert abs(float(a["layers.0.0.attn.wq"].float().std()) - 64**-0.5) < 0.02


def test_moe_decoder_matches_the_port_with_its_drops():
    prog = tiny.MOE
    w, cfg, lm = _port(prog)
    tokens = _tokens(4, 48, prog["vocab"])
    got, ids = _prefill(cfg, lm, tokens, record=True)
    want, shortfall, own = moe_decoder.prefill_last_logits(w, prog, tokens, routes=ids)
    torch.testing.assert_close(want, got, rtol=1e-4, atol=1e-4)
    assert shortfall <= 1e-5  # float32 routes are the reference's own top-k
    want_own, _, _ = moe_decoder.prefill_last_logits(w, prog, tokens)
    torch.testing.assert_close(want_own, got, rtol=1e-4, atol=1e-4)
    assert all(torch.equal(a, b) for a, b in zip(own, ids))
    # capacity 1.25 x the mean load: some slots are dropped at this size
    T, k, E = 4 * 48, 2, 8
    C = moe_decoder.capacity(T, k, E, 1.25)
    counts = torch.bincount(ids[0].reshape(-1), minlength=E)
    assert int(counts.max()) > C


def test_moe_route_shortfall_flags_a_bad_route():
    prog = tiny.MOE
    w, cfg, lm = _port(prog)
    tokens = _tokens(2, 16, prog["vocab"])
    _, ids = _prefill(cfg, lm, tokens, record=True)
    bad = [i.clone() for i in ids]
    bad[1][0, 0] = torch.tensor([7, 6]) if set(bad[1][0, 0].tolist()) != {6, 7} else torch.tensor([0, 1])
    _, s_ok, _ = moe_decoder.prefill_last_logits(w, prog, tokens, routes=ids)
    _, s_bad, _ = moe_decoder.prefill_last_logits(w, prog, tokens, routes=bad)
    assert s_bad > 100 * max(s_ok, 1e-7)
    dup = [i.clone() for i in ids]
    dup[0][0, 0, 1] = dup[0][0, 0, 0]
    assert moe_decoder.prefill_last_logits(w, prog, tokens, routes=dup)[1] == float("inf")


def test_mamba2_prefill_matches_the_port():
    prog = tiny.MAMBA
    w, cfg, lm = _port(prog)
    tokens = _tokens(3, 64, prog["vocab"])
    got, _ = _prefill(cfg, lm, tokens)
    want, _, _ = mamba2.prefill_last_logits(w, prog, tokens)
    torch.testing.assert_close(want, got, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("S,chunk", [(1, 64), (7, 64), (40, 64), (40, 16), (64, 16), (150, 64)])
def test_chunked_scan_is_the_recurrence(S, chunk):
    g = torch.Generator().manual_seed(S)
    B, H, P, N = 2, 3, 4, 5
    xh, bm, cm = (torch.randn(s, generator=g) for s in ((B, S, H, P), (B, S, N), (B, S, N)))
    da = -torch.rand((B, S, H), generator=g) * 2
    ins = [t.requires_grad_() for t in (xh, bm, cm, da)]
    got, want = mamba2.ssd_chunked(*ins, chunk=chunk), mamba2.ssd_sequential(*ins)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # and the gradients the training reference takes through it
    probe = torch.randn(want.shape, generator=g)
    for a, b in zip(torch.autograd.grad((got * probe).sum(), ins),
                    torch.autograd.grad((want * probe).sum(), ins)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_mamba2_training_matches_the_port():
    """Three AdamW steps of the reference against the port's step in float32
    (kernels' plain versions), from the same weights and batches: each
    step's loss, each leaf's first gradient and each leaf's change."""
    import traffic
    from repro_torch.train import optimizer as optim
    from repro_torch.train.step import make_train_step

    prog = tiny.MAMBA
    opt_cfg = tiny.TRAIN["optimizer"]
    w, cfg, lm = _port(prog, requires_grad=True)
    w0 = {n: t.detach().clone() for n, t in w.items()}
    opt = optim.adamw(**opt_cfg)
    params = dict(lm.named_parameters())
    state = opt.init(params)
    step = make_train_step(cfg, program.runtime("cpu", "float32", "reference"), opt)
    src = traffic.SyntheticTokens(prog["vocab"], 32, 4, seed=SEED)
    batches = [src.batch(i) for i in range(3)]
    losses = []
    for i, b in enumerate(batches):
        _, state, m = step(lm, state, {k: torch.as_tensor(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        if i == 0:
            g1 = {n: float(state["m"][n].norm()) / (1 - opt_cfg["b1"]) for n in params}
    ref = mamba2.train_steps(w0, prog, [(b["tokens"], b["labels"]) for b in batches], opt_cfg)
    assert losses == pytest.approx(ref["loss"], rel=1e-5)
    for n in params:
        assert g1[n] == pytest.approx(ref["grad_norm_1"][n], rel=1e-3, abs=1e-7), n
        delta = float((params[n].detach() - w0[n]).norm())
        assert delta == pytest.approx(ref["delta_norm"][n], rel=1e-3, abs=1e-8), n


def test_fp8_control_rounds_products():
    a = torch.randn(64, 64)
    q = plain.fp8_round(a)
    assert 0 < float((q - a).abs().max()) < 0.1 * float(a.abs().max())
    assert plain.Precision("fp8").mm(a, a).shape == (64, 64)
    with pytest.raises(ValueError):
        plain.Precision("fp16")
