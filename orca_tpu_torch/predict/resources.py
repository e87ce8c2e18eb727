"""Resource loading: models, genome, observed micro-C targets (counterpart of
orca_tpu/predict/resources.py).

The reference `load_resources` (orca_predict.py:42-228) without module
globals: returns an `OrcaResources` handle. Resources follow the reference
layout (models/orca_<name>.bundle pickles or *.statedict + resources/*.npy +
the hg38 FASTA / code memmap / rebinned mcools); missing optional pieces
degrade gracefully.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

from orca_tpu_torch.data.genome import CodeGenome, FastaGenome, MemmapGenome
from orca_tpu_torch.models import zoo
from orca_tpu_torch.utils.config import get_config, resolve_device

_MCOOLS = {"h1esc": "4DNFI9GMP2J8", "hff": "4DNFI643OYP9"}


@dataclasses.dataclass
class OrcaResources:
    models: Dict[str, object]
    genome: Optional[CodeGenome]  # hg38
    targets: Dict[str, object]
    target_available: bool
    # optional hg19 genome for GRCh37 coordinates (orca_predict.py:158-175)
    genome_hg19: Optional[CodeGenome] = None

    def bundles(self, names: List[str]):
        return [self.models[n] for n in names]

    def get_genome(self, assembly: str = "hg38"):
        if assembly in ("hg38", "GRCh38"):
            return self.genome
        if assembly in ("hg19", "GRCh37"):
            if self.genome_hg19 is None:
                raise ValueError(
                    "hg19 requested but Homo_sapiens.GRCh37.75 resources "
                    "are not present in the resource dir"
                )
            return self.genome_hg19
        raise ValueError(f"unknown assembly {assembly!r}")


def _bundle_path(model_dir: str, key: str) -> Optional[str]:
    """Path of a pre-converted bundle pickle (``orca_<key>.bundle``, written
    by `zoo.save_bundle` of either package) if present."""
    p = os.path.join(model_dir, f"orca_{key}.bundle")
    return p if os.path.exists(p) else None


def _fold(bundle):
    """Fold BatchNorm into the conv weights; a no-op on folded parameters."""
    if isinstance(bundle, zoo.Model256MBundle):
        return zoo.fold_256m_bundle(bundle)
    return zoo.fold_bundle(bundle)


def load_resources(models=("32M",), model_dir: Optional[str] = None,
                   resource_dir: Optional[str] = None,
                   use_memmapgenome: bool = True,
                   dtype: Optional[str] = None, device=None) -> OrcaResources:
    """Load requested model families ('32M', '1M', '256M', 'leukemia') onto
    `device` (None = CUDA), plus genome and observed micro-C target handles
    when the resource files exist.

    Each model loads from an ``orca_<name>.bundle`` pickle in model_dir in
    float32, is folded (the card's encoder tower takes folded parameters
    only), then cast to dtype (default: config param_dtype /
    ORCA_TPU_PARAM_DTYPE): 'bfloat16' is the serving precision, 'float32'
    reference parity. Folding comes before the cast, as in the JAX package,
    where bundles are folded in float32 when they are converted. A model dir
    without the pickle takes the statedict loaders, which raise until the
    converter is ported (ROADMAP A13); the 1 Mb and leukemia families raise
    likewise (A11, A12)."""
    device = resolve_device(device)
    cfg = get_config()
    model_dir = model_dir or cfg.model_dir
    resource_dir = resource_dir or cfg.resource_dir
    dtype = dtype or cfg.param_dtype

    out_models: Dict[str, object] = {}
    wanted = {m.lower() for m in models}

    def load(key, fallback, *a):
        p = _bundle_path(model_dir, key)
        if p is None:
            return fallback(*a)
        return _fold(zoo.load_bundle(p, device=device, dtype="float32"))

    if "32m" in wanted:
        for name in ("h1esc", "hff"):
            out_models[name] = load(
                name, zoo.load_32m_bundle, model_dir, resource_dir, name
            )
        hct = os.path.join(model_dir, "orca_hctnoc.net.statedict")
        if _bundle_path(model_dir, "hctnoc") or os.path.exists(hct):
            out_models["hctnoc"] = load(
                "hctnoc", zoo.load_32m_bundle, model_dir, resource_dir,
                "hctnoc",
            )
    if "1m" in wanted:
        for name in ("h1esc", "hff"):
            # no pickle path: the port has no Model1MBundle yet
            out_models[f"{name}_1m"] = zoo.load_1m_bundle(
                model_dir, resource_dir, name
            )
    if "256m" in wanted:
        for name in ("h1esc", "hff"):
            out_models[f"{name}_256m"] = load(
                f"{name}_256m", zoo.load_256m_bundle, model_dir,
                resource_dir, name,
            )
    if "leukemia" in wanted:
        # multi-cell-type leukemia bundles (orca_leukemia.py:1604-1873):
        # A = 2 heads, B = 6 heads; load whichever statedicts are present
        found = False
        for name in ("leukemiaA", "leukemiaB"):
            if os.path.exists(
                os.path.join(model_dir, f"orca_{name}.net.statedict")
            ):
                out_models[name] = zoo.load_leukemia_bundle(
                    model_dir, resource_dir, name
                )
                found = True
        if not found:
            raise FileNotFoundError(
                f"leukemia models requested but no orca_leukemia*.net"
                f".statedict found in {model_dir}"
            )

    out_models = {k: zoo.cast_bundle(b, dtype) for k, b in out_models.items()}

    genome = _load_genome(
        resource_dir, use_memmapgenome,
        "Homo_sapiens.GRCh38.dna.primary_assembly",
    )
    genome_hg19 = _load_genome(
        resource_dir, use_memmapgenome,
        "Homo_sapiens.GRCh37.75.dna.primary_assembly",
    )
    targets, available = _load_targets(resource_dir)
    return OrcaResources(out_models, genome, targets, available,
                         genome_hg19=genome_hg19)


def _load_genome(resource_dir: str, use_memmap: bool, stem: str):
    code_mmap = os.path.join(resource_dir, f"{stem}.codes.mmap")
    fasta = os.path.join(resource_dir, f"{stem}.fa")
    if use_memmap and os.path.exists(code_mmap):
        return MemmapGenome(code_mmap)
    if os.path.exists(fasta):
        if use_memmap:
            return MemmapGenome.build(fasta, code_mmap)
        return FastaGenome(fasta)
    return None


def _load_targets(resource_dir: str):
    from orca_tpu_torch.data.targets import CoolerContactMatrix

    targets = {}
    available = True
    for name, stem in _MCOOLS.items():
        mcool = os.path.join(resource_dir, f"{stem}.rebinned.mcool")
        if not os.path.exists(mcool):
            available = False
            continue
        # per-resolution window shapes: 32Mb@4kb and 256Mb@32kb are
        # 8000x8000; the 1Mb model's 1kb target window is 1000x1000
        # (orca_predict.py:178-226)
        for suffix, res, nbins in (
            ("", 4000, 8000), ("_256m", 32000, 8000), ("_1m", 1000, 1000)
        ):
            targets[f"{name}{suffix}"] = CoolerContactMatrix(
                f"{mcool}::/resolutions/{res}", (nbins, nbins), cg=True
            )
    return targets, available
