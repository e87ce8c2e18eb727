"""Device meshes and the sequence-sharded encoder tower."""

from orca_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from orca_tpu_torch.parallel.sequence import sharded_encoder_tower  # noqa: F401
