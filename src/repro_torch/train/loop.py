"""End-to-end trainer (``repro/train/loop.py``): init or restore -> step
loop -> periodic async checkpoints, with failure recovery (resume from
LATEST) and straggler-tolerant data fetch. Used by ``launch/train.py``.

The weights are drawn from a ``torch.Generator`` seeded with
``TrainerConfig.seed`` on the runtime's device (the reference draws from
``jax.random.PRNGKey(seed)``); the data are the reference's NumPy draws.

With a mesh runtime (``launch.specs.make_runtime``) every rank draws the same
weights, lays them out on the mesh in the 2d layout (``interop.place_params``,
pure data parallel where the config says so), keeps the optimizer state in
the parameters' placements, and runs the step on the same global batch, of
which the model takes the rank's rows. Every rank saves (rank 0 writes) and
restores the same checkpoints. ``run_with_recovery`` restarts in process on
a mesh as on one device: a failure that every rank raises at the same step
(between steps, so no rank is inside a collective) rebuilds the trainer on
every rank and resumes from LATEST. A broken process group
(``torch.distributed.DistBackendError``: a rank left, or a collective timed
out) is raised instead, and the restart is the launch's, in fresh processes
that resume from LATEST.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch import interop
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import Prefetcher, SyntheticTokens
from repro_torch.models.layers import Runtime
from repro_torch.models.layers import local_shard as _local
from repro_torch.models.model import init_params
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import Optimizer, for_config
from repro_torch.train.step import make_train_step

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    seq_len: int = 256
    global_batch: int = 8
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = DEFAULT_CKPT_DIR
    seed: int = 0
    lr: float = 3e-4
    log_every: int = 10


class Trainer:
    """``runtime=None`` is float32 compute on the CUDA device (RuntimeError
    without one). ``params`` is the model (an ``LM``), updated in place."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig, runtime: Runtime | None = None,
                 optimizer: Optimizer | None = None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.runtime = runtime or Runtime(compute_dtype=torch.float32)
        self.optimizer = optimizer or for_config(cfg, lr=tcfg.lr)
        self.step_fn = make_train_step(cfg, self.runtime, self.optimizer)
        self.data = SyntheticTokens(cfg.vocab, tcfg.seq_len, tcfg.global_batch, seed=tcfg.seed)
        self.params = None
        self.opt_state = None
        self.step = 0
        self.history: list[dict] = []

    def _state(self):
        return {"params": dict(self.params.named_parameters()), "opt": self.opt_state}

    # ------------------------------------------------------------------
    def init_or_restore(self):
        dev = self.runtime.device
        self.params = init_params(self.cfg, torch.Generator(device=dev).manual_seed(self.tcfg.seed),
                                  device=dev)
        if self.runtime.mesh is not None:
            interop.place_params(self.params, self.cfg, self.runtime.mesh,
                                 pure_dp=self.cfg.pure_dp)
        self.opt_state = self.optimizer.init(dict(self.params.named_parameters()))
        if self.runtime.mesh is not None:  # no rank reads LATEST before rank 0 wrote it
            dist.barrier()
        latest = ckpt.latest_step(self.tcfg.ckpt_dir)
        if latest is not None:
            _, state = ckpt.restore(self.tcfg.ckpt_dir, self._state())
            with torch.no_grad():
                for name, p in self.params.named_parameters():
                    _local(p).copy_(_local(state["params"][name]))
            self.opt_state = state["opt"]
            self.step = latest
        return self.step

    # ------------------------------------------------------------------
    def run(self, steps: int | None = None, fail_at: int | None = None):
        """Run the loop; ``fail_at`` injects a simulated crash (tests exercise
        the restart path by constructing a fresh Trainer and resuming)."""
        steps = steps if steps is not None else self.tcfg.steps
        dev = self.runtime.device
        pre = Prefetcher(self.data, start_step=self.step)
        pending_ckpt = None
        try:
            while self.step < steps:
                got = pre.next(timeout=10.0, skip_slow=True)
                if got is None:  # straggler: skip this fetch, keep the step going
                    continue
                _, batch = got
                batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
                t0 = time.time()
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch
                )
                self.step += 1
                if fail_at is not None and self.step >= fail_at:
                    raise RuntimeError(f"injected failure at step {self.step}")
                if self.step % self.tcfg.log_every == 0 or self.step == steps:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["step"] = self.step
                    m["dt"] = time.time() - t0
                    self.history.append(m)
                if self.step % self.tcfg.ckpt_every == 0 or self.step == steps:
                    if pending_ckpt is not None:
                        pending_ckpt.join()
                    pending_ckpt = ckpt.save(self.tcfg.ckpt_dir, self.step, self._state(),
                                             blocking=False)
        finally:
            pre.close()
            if pending_ckpt is not None:
                pending_ckpt.join()
        if self.runtime.mesh is not None:  # every rank returns after rank 0 wrote
            dist.barrier()
        return self.history


def run_with_recovery(make_trainer, total_steps: int, max_restarts: int = 3,
                      fail_at: int | None = None):
    """Launcher-level fault tolerance: on failure, rebuild the trainer (fresh
    process semantics), restore from LATEST and continue; the history holds
    the finished run's logs. On a mesh every rank restarts together: the
    ranks meet at a barrier before the rebuild. A broken process group's
    error (``DistBackendError``) is raised on a mesh, since its barrier could
    not meet; the restart is then fresh processes resuming from LATEST."""
    restarts = 0
    history = []
    while True:
        tr = make_trainer()
        tr.init_or_restore()
        try:
            history += tr.run(steps=total_steps, fail_at=fail_at)
            return history, restarts
        except RuntimeError as e:
            mesh = tr.runtime.mesh is not None
            if mesh and isinstance(e, dist.DistBackendError):
                raise
            restarts += 1
            fail_at = None  # only fail once in tests
            if restarts > max_restarts:
                raise
            if mesh:  # every rank enters the rebuild together
                dist.barrier()
