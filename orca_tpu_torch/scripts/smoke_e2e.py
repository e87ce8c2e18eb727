"""End-to-end product-path smoke on the CUDA card (counterpart of the JAX
package's scripts/smoke_e2e.py): synthetic genome -> 32 Mb region predict +
duplication screen -> PDFs.

Drives the real pipelines (genome encoding, the zoom cascade with the fused
conv-chain kernels, the structural-variant algebra, genomeplot rendering)
at full geometry with one random bf16 32 Mb bundle on a genome of two 40 Mb
chromosomes: `process_region` over 2 Mb (one window), then `process_dup`
over 1 Mb (three windows: ref.l, ref.r, alt). Expected: pred.pdf and
dup.{alt,ref.l,ref.r}.pdf. The first call pays the process's first-request
set-up (cuDNN's plans, the allocator's pools, the kernels' nvcc build when
none is cached).

`--plots pdf` (the default) draws the PDFs with matplotlib and fails at the
start when matplotlib is not importable; `--plots record` replaces
`viz.genomeplot` by a recorder of the file names, and the four names are
asserted as recorded.

    python -m orca_tpu_torch.scripts.smoke_e2e [OUTDIR] [--json PATH]
        [--plots pdf|record]

With --json, merges the PDF names, the timings and the card's name and
power limit into the given JSON file (reference product surface being
smoked: orca_predict.py:3168-3391). OUTDIR defaults to `orca_tpu_torch_smoke`
in the temporary directory.
"""

from __future__ import annotations

import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

from orca_tpu_torch.scripts._common import card_fields, require_matplotlib
from orca_tpu_torch.utils.config import resolve_device

PDFS = ["dup.alt.pdf", "dup.ref.l.pdf", "dup.ref.r.pdf", "pred.pdf"]


def merge_json(path, fields):
    out = {}
    if path and os.path.exists(path):
        with open(path) as f:
            out = json.load(f)
    out.update(fields)
    if path:
        with open(path, "w") as f:
            f.write(json.dumps(out, indent=2))
    return out


def main(outdir=None, json_path=None, plots="pdf", device=None) -> dict:
    """Run the smoke and print its record; returns it. `device` None means
    the CUDA card (raises without it); tests pass "cpu"."""
    from orca_tpu_torch import viz
    from orca_tpu_torch.data.genome import CodeGenome
    from orca_tpu_torch.models import zoo
    from orca_tpu_torch.predict import pipelines

    device = resolve_device(device)
    if plots not in ("pdf", "record"):
        raise ValueError(f"--plots {plots!r}: pdf or record")
    if plots == "pdf":
        require_matplotlib("smoke_e2e")
    outdir = outdir or os.path.join(tempfile.gettempdir(),
                                    "orca_tpu_torch_smoke")

    rng = np.random.RandomState(0)
    gen = CodeGenome({
        "chrT": rng.randint(0, 4, 40_000_000).astype(np.uint8),
        "chr1": rng.randint(0, 4, 40_000_000).astype(np.uint8),
    })
    bundle = zoo.cast_bundle(
        zoo.fold_bundle(zoo.random_32m_bundle(seed=0, device=device)),
        "bfloat16",
    )
    os.makedirs(outdir, exist_ok=True)
    recorded = []
    saved = (viz.genomeplot, viz.genomeplot_256mb)
    if plots == "record":
        def record(output, file=None, **kw):
            recorded.append(os.path.basename(file))

        viz.genomeplot = viz.genomeplot_256mb = record
    try:
        t0 = time.perf_counter()
        pipelines.process_region("chrT", 19_000_000, 21_000_000, genome=gen,
                                 models=[bundle], file=outdir + "/pred",
                                 show_genes=False, device=device)
        region_s = time.perf_counter() - t0
        print(f"process_region: {region_s:.1f}s (incl. compile)")
        t0 = time.perf_counter()
        pipelines.process_dup("chrT", 19_500_000, 20_500_000, genome=gen,
                              models=[bundle], file=outdir + "/dup",
                              show_genes=False, device=device)
        dup_s = time.perf_counter() - t0
        print(f"process_dup: {dup_s:.1f}s (compiled programs reused)")
    finally:
        viz.genomeplot, viz.genomeplot_256mb = saved

    if plots == "record":
        outs = sorted(recorded)
    else:
        outs = sorted(os.path.basename(p)
                      for p in glob.glob(outdir + "/*.pdf"))
    if outs != PDFS:
        raise RuntimeError(f"smoke_e2e: plots {outs}, expected {PDFS}")
    card = card_fields(device)
    record = merge_json(json_path, {
        "smoke_pdfs": outs,
        "smoke_region_s_incl_compile": region_s,
        "smoke_dup_screen_s": dup_s,
        "smoke_device": card["device"],
        "power_limit_w": card["power_limit_w"],
        "smoke_plots": plots,
    })
    print("ok:", json.dumps(record), flush=True)
    return record


def _parse(argv):
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m orca_tpu_torch.scripts.smoke_e2e",
        description="genome -> region and dup screens -> PDFs on the CUDA "
                    "card")
    p.add_argument("outdir", nargs="?", default=None)
    p.add_argument("--json", dest="json_path", default=None,
                   help="merge the record into this JSON file")
    p.add_argument("--plots", choices=["pdf", "record"], default="pdf",
                   help="pdf: draw the PDFs (needs matplotlib); record: "
                        "record their file names instead")
    return p.parse_args(argv)


if __name__ == "__main__":
    a = _parse(sys.argv[1:])
    main(a.outdir, json_path=a.json_path, plots=a.plots)
