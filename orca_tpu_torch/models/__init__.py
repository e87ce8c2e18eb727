"""Model bundles and weights carried across from the JAX package."""

from orca_tpu_torch.models import convert, zoo  # noqa: F401
