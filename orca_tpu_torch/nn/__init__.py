"""Conv blocks, encoders and decoders."""

from orca_tpu_torch.nn.core import (  # noqa: F401
    Unit,
    Block,
    init_block,
    apply_block,
    BNUpdates,
)
from orca_tpu_torch.nn import encoders, decoders  # noqa: F401
