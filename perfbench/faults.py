"""Faults planted in the program underneath a run, for the tests and the
readings that show the check fails them. Each is a context manager that
patches a program function for its block (the program's own module globals,
looked up at call time by its callers).

  state_unchanged  (train)    the optimizer's update leaves parameters and
                              state as they were
  half_batch       (both)     half of the batch's rows left out: prefill
                              serves the first half's tokens to the second
                              half; training's loss is the mean over the
                              first half
  token_altered    (prefill)  the first row's served token is another one
  grad_altered     (train)    the embedding's gradient doubled where the
                              backward hands it to the optimizer
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name, make):
    old = getattr(module, name)
    setattr(module, name, make(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def state_unchanged():
    from repro_torch.train import optimizer

    def make(adamw):
        def broken(**kw):
            base = adamw(**kw)
            return optimizer.Optimizer(init=base.init, update=lambda g, s, p: (p, s),
                                       name=base.name)
        return broken

    return _patched(optimizer, "adamw", make)


def half_batch_prefill():
    from repro_torch.serve import step

    def make(make_prefill_step):
        def broken(cfg, runtime):
            inner = make_prefill_step(cfg, runtime)

            def prefill_step(lm, batch):
                toks = batch["tokens"]
                h = max(toks.shape[0] // 2, 1)
                last = inner(lm, {"tokens": toks[:h]})
                return torch.cat([last, last[:toks.shape[0] - h]])
            return prefill_step
        return broken

    return _patched(step, "make_prefill_step", make)


def token_altered():
    from repro_torch.serve import step

    def make(make_prefill_step):
        def broken(cfg, runtime):
            inner = make_prefill_step(cfg, runtime)

            def prefill_step(lm, batch):
                last = inner(lm, batch).clone()
                last[0] = last[0].roll(1)
                return last
            return prefill_step
        return broken

    return _patched(step, "make_prefill_step", make)


def half_batch_train():
    from repro_torch.train import step

    def make(lm_loss):
        def broken(lm, cfg, runtime, tokens, labels, extra=None, **kw):
            h = max(tokens.shape[0] // 2, 1)
            return lm_loss(lm, cfg, runtime, tokens[:h], labels[:h], extra, **kw)
        return broken

    return _patched(step, "lm_loss", make)


def grad_altered():
    from repro_torch.train import step

    def make(global_norm):
        def broken(grads):
            grads["embed"].mul_(2.0)
            return global_norm(grads)
        return broken

    return _patched(step, "global_norm", make)


PREFILL = {"half_batch": half_batch_prefill, "token_altered": token_altered}
TRAIN = {"state_unchanged": state_unchanged, "half_batch": half_batch_train,
         "grad_altered": grad_altered}


def for_entry(entry: str) -> dict:
    return {"prefill": PREFILL, "train": TRAIN}[entry]
