"""Training: losses, the optimizer, weight averaging, stages and trainers."""

from orca_tpu_torch.training import losses, optim, swa  # noqa: F401
