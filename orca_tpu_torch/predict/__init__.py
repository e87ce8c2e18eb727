"""User-facing prediction API (counterpart of orca_tpu/predict/__init__.py):
`load_resources`, the multiscale predictors, and the `process_*` variant
pipelines. Entry points run on CUDA unless given device="cpu".

    from orca_tpu_torch import predict
    res = predict.load_resources(models=["32M"], dtype="bfloat16")
    predict.process_region("chr9", 94904000, 126904000, res.genome,
                           res.bundles(["h1esc", "hff"]))
"""

from orca_tpu_torch.predict.multiscale import (  # noqa: F401
    genomepredict,
    genomepredict_256mb,
)
from orca_tpu_torch.predict.pipelines import (  # noqa: F401
    process_anno,
    process_custom,
    process_del,
    process_dup,
    process_ins,
    process_inv,
    process_region,
    process_seqstr,
    process_single_breakpoint,
)
from orca_tpu_torch.predict.resources import load_resources  # noqa: F401
from orca_tpu_torch.predict.structural import StructuralChange  # noqa: F401
