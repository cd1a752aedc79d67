"""The traffic generator: deterministic from the seed, the Engine's groups
and pads, the same work for every seed, and the training stream's rows."""
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import traffic  # noqa: E402

MIX = traffic.load(HERE / "traffic" / "prefill-backlog.json")
SEED = 2**33 + 17


def test_backlog_is_a_function_of_the_seed():
    a, b = traffic.Backlog(MIX, SEED, 163840), traffic.Backlog(MIX, SEED, 163840)
    for g in (0, 5, 13):
        ga, gb = a.group(g), b.group(g)
        assert ga.rids == gb.rids and ga.lengths == gb.lengths
        np.testing.assert_array_equal(ga.tokens, gb.tokens)
    other = traffic.Backlog(MIX, SEED + 1, 163840).group(0)
    assert not np.array_equal(other.tokens, a.group(0).tokens)


def test_every_seed_sends_the_same_work():
    shapes = [[traffic.Backlog(MIX, s, 1000).group(g).shape for g in range(24)]
              for s in (1, SEED, 2**31 + 5)]
    reals = [[traffic.Backlog(MIX, s, 1000).group(g).real_tokens for g in range(24)]
             for s in (1, SEED)]
    assert shapes[0] == shapes[1] == shapes[2]
    assert reals[0] == reals[1]


@pytest.mark.parametrize("multiple", [1, 256])
def test_groups_follow_the_engine_rule(multiple):
    backlog = traffic.Backlog(MIX, SEED, 1000, multiple)
    for g in range(10):
        grp = backlog.group(g)
        S = -(-max(grp.lengths) // multiple) * multiple
        assert grp.shape == (MIX["slots"], S)
        assert grp.rids == list(range(g * MIX["slots"], (g + 1) * MIX["slots"]))
        for row, n in enumerate(grp.lengths):
            assert (grp.tokens[row, :S - n] == MIX["pad_token"]).all()
            assert (grp.tokens[row, S - n:] != MIX["pad_token"]).any()
            assert 128 <= n <= 4096
    # the Engine's own left pad, on the same prompts
    prompts = [(i, np.arange(1, n + 1)) for i, n in enumerate([3, 5, 2])]
    (rids, lens, toks), = traffic.engine_groups(prompts, 8, 0)
    np.testing.assert_array_equal(toks, [[0, 0, 1, 2, 3], [1, 2, 3, 4, 5], [0, 0, 0, 1, 2]])


def test_lengths_and_pad_share():
    lengths = traffic.prompt_lengths(MIX)
    assert len(lengths) == MIX["cycle_requests"]
    assert sorted(lengths) == lengths and max(lengths) == 4096
    assert 1000 <= float(np.median(lengths)) <= 1040  # the trace's median, 1020
    assert len({n % 256 for n in lengths}) > 16  # the lengths as drawn, not rounded
    assert traffic.pad_share(MIX) == pytest.approx(0.575, abs=0.01)
    assert traffic.pad_share(MIX, 256) == pytest.approx(0.590, abs=0.01)
    assert traffic.group_shapes(MIX)[0] == (8, 4096)
    assert all(S % 256 == 0 for _, S in traffic.group_shapes(MIX, 256))


def test_train_stream_rows_differ_and_repeat():
    mix = traffic.load(HERE / "traffic" / "train-2k.json")
    src = traffic.train_source(dict(mix, batch=4, seq_len=16), SEED, 50280)
    a, b = src.batch(0), src.batch(1)
    np.testing.assert_array_equal(a["tokens"], src.batch(0)["tokens"])
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    rows = np.concatenate([a["tokens"], b["tokens"]])
    assert len({r.tobytes() for r in rows}) == len(rows)
    feed = traffic.Prefetcher(src, depth=2)
    try:
        for want in range(3):
            step, batch = feed.next(timeout=30)
            assert step == want
            np.testing.assert_array_equal(batch["tokens"], src.batch(want)["tokens"])
    finally:
        feed.close()
    assert not feed._thread.is_alive()
