"""Host-side data: genome sequence stores and contact-matrix targets."""

from orca_tpu_torch.data.genome import (  # noqa: F401
    CodeGenome,
    FastaGenome,
    MemmapGenome,
    sequence_to_encoding,
    encoding_to_codes,
)
