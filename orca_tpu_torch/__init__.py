"""orca_tpu_torch — the PyTorch/CUDA port of orca_tpu for NVIDIA Hopper.

Mirrors the JAX package's module names (utils, ops, nn, models, data,
training, predict, parallel, viz, colormaps), its public re-exports and its
channels-last layouts. The bp-resolution encoder tower runs as
hand-written CUDA kernels (csrc/, built with nvcc on first use); the rest is
PyTorch. Entry points take `device=None`, meaning CUDA, and raise when CUDA is
absent; pass device="cpu" to run the plain versions on the CPU.
"""

__version__ = "0.1.0"

from orca_tpu_torch.utils.config import (  # noqa: F401
    OrcaConfig,
    get_config,
    set_config,
)
from orca_tpu_torch.ops.nn_ops import (  # noqa: F401
    conv1d,
    conv2d,
    maxpool1d,
    batchnorm,
    relu,
    sigmoid,
    upsample1d_nearest,
    upsample2d_nearest,
    upsample2d_bilinear,
    fold_bn_into_conv,
)
from orca_tpu_torch.nn.core import (  # noqa: F401
    Unit,
    Block,
    init_block,
    apply_block,
    BNUpdates,
)
from orca_tpu_torch.nn import encoders, decoders  # noqa: F401
from orca_tpu_torch.training import losses, optim, swa  # noqa: F401
from orca_tpu_torch.models import convert, zoo  # noqa: F401
from orca_tpu_torch.data.genome import (  # noqa: F401
    CodeGenome,
    FastaGenome,
    MemmapGenome,
    sequence_to_encoding,
    encoding_to_codes,
)
