"""The port's checkpoints (``repro_torch.train.checkpoint``), data pipeline
(``repro_torch.data.pipeline``, a copy of the reference's) and Trainer
failure recovery (``repro_torch.train.loop``): the counterparts of
``tests/test_checkpoint_data.py``, plus the port's batches held equal to the
reference's for the same (seed, step, host)."""
import json

import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticTokens as RefSyntheticTokens
from repro_torch.data.pipeline import Prefetcher, SyntheticTokens
from repro_torch.train import checkpoint as ckpt


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run many small CPU operations; with a test worker per core,
    torch's pool of one thread per core oversubscribes the CPU and slows them
    by tens of times, so each test runs on one thread (restored after)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _tree():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": {"c": torch.tensor([1.0, -2.5, 3.0e-3], dtype=torch.bfloat16),
              "d": torch.zeros((), dtype=torch.int32)},
    }


def _leaves(tree):
    return [leaf for _, leaf in ckpt._flatten(tree)]


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    ckpt.save(tmp_path, 7, tree)
    assert ckpt.latest_step(tmp_path) == 7
    step, restored = ckpt.restore(tmp_path, tree)
    assert step == 7
    for a, b in zip(_leaves(tree), _leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    manifest = json.loads((tmp_path / "step_7" / "manifest.json").read_text())
    assert manifest["paths"] == ["a", "b/c", "b/d"]
    assert manifest["dtypes"] == ["float32", "bfloat16", "int32"]
    assert manifest["shapes"] == [[3, 4], [3], []] and manifest["n_leaves"] == 3
    with np.load(tmp_path / "step_7" / "shard_0.npz") as data:
        assert data["leaf_1"].dtype == np.int16  # bf16 stored as its bits


def test_checkpoint_latest_pointer_advances(tmp_path):
    tree = {"w": torch.zeros(4)}
    ckpt.save(tmp_path, 1, tree)
    ckpt.save(tmp_path, 2, {"w": torch.ones(4)})
    step, restored = ckpt.restore(tmp_path, tree)
    assert step == 2 and float(restored["w"][0]) == 1.0
    step, restored = ckpt.restore(tmp_path, tree, step=1)
    assert step == 1 and float(restored["w"][0]) == 0.0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["LATEST", "step_1", "step_2"]


def test_checkpoint_async_copies_the_state_at_once(tmp_path):
    """save(blocking=False) returns the writer thread; the host copy is taken
    before it returns, so a tensor updated in place meanwhile (as the train
    loop updates its parameters) does not reach the checkpoint."""
    tree = {"w": torch.full((8, 8), 3.0)}
    t = ckpt.save(tmp_path, 5, tree, blocking=False)
    tree["w"].add_(1.0)
    t.join(timeout=60)
    assert not t.is_alive()
    step, restored = ckpt.restore(tmp_path, tree)
    assert step == 5 and float(restored["w"][0, 0]) == 3.0


def test_restore_device_and_mismatched_tree(tmp_path):
    tree = _tree()
    ckpt.save(tmp_path, 3, tree)
    _, restored = ckpt.restore(tmp_path, tree, device="cpu")
    assert all(leaf.device == torch.device("cpu") for leaf in _leaves(restored))
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(tmp_path, {"a": tree["a"]})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "empty", tree)


@pytest.mark.parametrize("seed,step,n_hosts,host_id", [(0, 0, 1, 0), (3, 5, 2, 0), (3, 5, 2, 1),
                                                       (7, 123, 4, 3)])
def test_synthetic_tokens_equal_the_references(seed, step, n_hosts, host_id):
    """The port's batches are the reference's, bit for bit, for the same
    (seed, step, host)."""
    kw = dict(seed=seed, n_hosts=n_hosts, host_id=host_id)
    got = SyntheticTokens(50280, 64, 8, **kw).batch(step)
    want = RefSyntheticTokens(50280, 64, 8, **kw).batch(step)
    assert sorted(got) == sorted(want) == ["labels", "tokens"]
    for k in got:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])


def test_data_determinism_and_sharding():
    src0 = SyntheticTokens(1000, 16, 8, seed=3, n_hosts=2, host_id=0)
    src0b = SyntheticTokens(1000, 16, 8, seed=3, n_hosts=2, host_id=0)
    src1 = SyntheticTokens(1000, 16, 8, seed=3, n_hosts=2, host_id=1)
    b0 = src0.batch(5)
    np.testing.assert_array_equal(b0["tokens"], src0b.batch(5)["tokens"])  # pure fn
    assert not np.array_equal(b0["tokens"], src1.batch(5)["tokens"])  # hosts differ
    assert b0["tokens"].shape == (4, 16)
    np.testing.assert_array_equal(b0["tokens"][:, 1:], b0["labels"][:, :-1])
    assert b0["tokens"].max() < 1000


def test_prefetcher_orders_batches():
    src = SyntheticTokens(100, 8, 4, seed=0)
    pre = Prefetcher(src, start_step=10, depth=2)
    s0, b0 = pre.next(timeout=5)
    s1, _ = pre.next(timeout=5)
    pre.close()
    assert (s0, s1) == (10, 11)
    np.testing.assert_array_equal(b0["tokens"], src.batch(10)["tokens"])


def _trainer_cfg(tmp, sub):
    from repro_torch.train.loop import TrainerConfig

    return TrainerConfig(seq_len=16, global_batch=4, steps=12, ckpt_every=4,
                         ckpt_dir=str(tmp / sub), seed=0, log_every=1)


def test_trainer_failure_recovery(tmp_path):
    """Inject a crash mid-run; the launcher restarts from LATEST and the final
    state matches an uninterrupted run (within the reference's atol 1e-6)."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import Runtime
    from repro_torch.train.loop import Trainer, run_with_recovery

    cfg = get_config("gemma-2b").reduced()
    rt = Runtime("cpu", torch.float32)
    tr_ref = Trainer(cfg, _trainer_cfg(tmp_path, "ref"), rt)
    tr_ref.init_or_restore()
    hist_ref = tr_ref.run()
    assert [h["step"] for h in hist_ref] == list(range(1, 13))
    hist, restarts = run_with_recovery(
        lambda: Trainer(cfg, _trainer_cfg(tmp_path, "rec"), rt), total_steps=12, fail_at=6)
    assert restarts == 1
    assert [h["step"] for h in hist] == list(range(5, 13))  # the resumed run's, from step 4
    tr_rec = Trainer(cfg, _trainer_cfg(tmp_path, "rec"), rt)
    assert tr_rec.init_or_restore() == 12
    for a, b in zip(tr_ref.params.parameters(), tr_rec.params.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-6)
    assert int(tr_rec.opt_state["step"]) == 12
    for k in ("m", "v"):
        for name, t in tr_ref.opt_state[k].items():
            np.testing.assert_allclose(t.numpy(), tr_rec.opt_state[k][name].numpy(), atol=1e-6)


def test_trainer_draws_its_weights_from_the_seed(tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.models.layers import Runtime
    from repro_torch.train.loop import Trainer

    cfg = get_config("mamba2-130m").reduced()
    rt = Runtime("cpu", torch.float32)
    a, b = (Trainer(cfg, _trainer_cfg(tmp_path, sub), rt) for sub in ("a", "b"))
    assert a.init_or_restore() == b.init_or_restore() == 0
    for p, q in zip(a.params.parameters(), b.params.parameters()):
        assert torch.equal(p, q)
    assert a.optimizer.name == "adamw"
