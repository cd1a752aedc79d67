"""Training: optimizers, the train step, checkpoints and the Trainer loop
(``repro/train``, in PyTorch)."""
