"""The work formulas against hand counts at small shapes, and against
torch's FLOP counter on plain versions where the two count the same."""
import json
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import work  # noqa: E402


def test_flash_call_by_hand():
    # B 1, S 4, KV 1, G 2, hd 8: 10 causal pairs, 4·8 FLOPs a pair and head
    flops, nbytes = work.flash_call((1, 4, 1, 2, 8), (1, 4, 1, 8), True, 2)
    assert flops == 4 * 8 * 2 * 10
    assert nbytes == 2 * (2 * 4 * 2 * 8 + 2 * 4 * 8)
    full, _ = work.flash_call((1, 4, 1, 2, 8), (1, 6, 1, 8), False, 4)
    assert full == 4 * 8 * 2 * 24


def test_flash_full_rectangle_matches_the_flop_counter():
    q, k, v = torch.randn(2, 16, 3, 8), torch.randn(2, 16, 3, 8), torch.randn(2, 16, 3, 8)
    with FlopCounterMode(display=False) as fc:
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    flops, _ = work.flash_call((2, 16, 3, 1, 8), (2, 16, 3, 8), False, 4)
    assert flops == fc.get_total_flops()


def test_ssd_step_by_hand_and_counter():
    B, S, H, P, N, Q = 1, 8, 2, 4, 3, 4
    nc, pairs = 2, 10
    want = B * nc * (2 * N * pairs + H * (2 * P * pairs + 2 * Q * P * N))
    assert work.ssd_step_flops(B, S, H, P, N, Q) == want
    # the dense (unmasked) products as the plain chunk step writes them
    c, b = torch.randn(B, nc, Q, N), torch.randn(B, nc, Q, N)
    x = torch.randn(B, nc, Q, H, P)
    with FlopCounterMode(display=False) as fc:
        scores = torch.einsum("bcln,bcsn->bcls", c, b)
        torch.einsum("bcls,bcshp->bclhp", scores, x)
        torch.einsum("bcshp,bcsn->bchpn", x, b)
    dense = B * nc * (2 * N * Q * Q + H * (2 * P * Q * Q + 2 * Q * P * N))
    assert fc.get_total_flops() == dense
    assert want < dense


def test_ssd_bytes_by_hand():
    _, nbytes = work.ssd_chunks_call((2, 8, 3, 4), 5, 4)
    assert nbytes == 4 * (2 * 2 * 8 * 3 * 4 + 2 * 2 * 8 * 5 + 2 * 8 * 3 + 2 * 3 * 4 * 5)
    f_fwd, b_fwd = work.ssd_step_call((2, 8, 3, 4), 5, 4, backward=False)
    f_bwd, b_bwd = work.ssd_step_call((2, 8, 3, 4), 5, 4, backward=True)
    assert f_bwd == 2 * f_fwd and b_bwd > b_fwd


def test_least_time():
    assert work.least_time(989e12, 0, work.PEAK_BF16_FLOPS) == pytest.approx(1.0)
    assert work.least_time(0, 3.35e12, work.PEAK_BF16_FLOPS) == pytest.approx(1.0)


# the port's configs/moonshot_v1_16b_a3b.py at 27 layers: an MoE decoder's program group
MOE = {"name": "moonshot-v1-16b-a3b", "family": "moe", "n_layers": 27, "d_model": 2048,
       "n_heads": 16, "kv_heads": 16, "head_dim": 128, "d_ff": 1408, "vocab": 163840,
       "moe": {"n_experts": 64, "top_k": 6, "d_ff_expert": 1408}, "moe_every": 1,
       "act": "swiglu", "norm": "rmsnorm", "rope_theta": 50000.0, "moe_cf": 1.25,
       "tie_embeddings": False, "remat_policy": "dots", "microbatches": 1}


def _prog(name):
    if name == MOE["name"]:
        return MOE
    return json.loads((HERE / "configs" / f"{name}.json").read_text())["program"]


def test_model_flops_of_moonshot_by_hand():
    p = _prog("moonshot-v1-16b-a3b")
    d, L, V = 2048, 27, 163840
    attn = 2 * d * 128 * (16 + 32) + 2 * 16 * 128 * d
    moe = 2 * d * 64 + 6 * 3 * 2 * d * 1408
    length = 1024
    want = 2 * d * V + L * (length * (attn + moe) + 4 * 128 * 16 * length * (length + 1) // 2)
    assert work.prefill_flops(p, length) == pytest.approx(want, rel=1e-12)
    # about 3.7 GFLOP a token past the head
    assert 3.6e9 < (want - 2 * d * V) / length < 3.9e9


def test_dense_part_of_model_flops_matches_the_counter():
    """The products a token needs, as torch counts one token's plain
    projections of the MoE decoder (the k experts a token takes)."""
    p = _prog("moonshot-v1-16b-a3b")
    small = dict(p, n_layers=1, d_model=64, n_heads=4, kv_heads=2, head_dim=16, vocab=100,
                 moe={"n_experts": 8, "top_k": 2, "d_ff_expert": 32})
    x = torch.randn(1, 64)
    with FlopCounterMode(display=False) as fc:
        for out in (4 * 16, 2 * 16, 2 * 16):
            x @ torch.randn(64, out)
        torch.randn(1, 64) @ torch.randn(64, 64)  # o
        x @ torch.randn(64, 8)  # router
        for _ in range(2):
            x @ torch.randn(64, 32), x @ torch.randn(64, 32)
            torch.randn(1, 32) @ torch.randn(32, 64)
        x @ torch.randn(64, 100)  # head
    causal = 4 * 16 * 4 * 1  # one token attends to itself
    assert work.prefill_flops(small, 1) == fc.get_total_flops() + causal


def test_mamba_flops_and_train_factor():
    p = _prog("mamba2-130m")
    f1 = work.forward_flops(p, 2048, head_positions=2048)
    assert work.train_flops(p, 16, 2048) == pytest.approx(3 * 16 * f1)
    per_token = (f1 - 2048 * 2 * 768 * 50288) / 2048
    assert 1.5e8 < per_token < 2.5e8  # ~130M parameters' products plus the scan
