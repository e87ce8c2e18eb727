"""orca-tpu-torch command-line interface (counterpart of orca_tpu/cli.py).

Prediction modes mirror the reference CLI (orca_predict.py:3168-3391):
  region | del | dup | inv | break  <coordinate> <output_dir>
plus framework utilities:
  build-genome  FASTA -> uint8 code memmap
  expectation   cooltools expected TSV or a cooler/mcool -> .npy
                expectation files (the mcool path needs no cooltools)
  serve         warm prediction server: one process keeps its models on
                the card and answers commands read from stdin
  convert       the reference's torch statedicts -> a bundle pickle
  train         a training stage (a | b | c) from a TrainJob JSON
  bench         the benchmark (`orca_tpu_torch.bench`): one JSON line of
                Mb/s per card and training-step timings
The JAX package's `certify` keeps its arguments here but is not ported yet:
it exits with the ROADMAP item that will port it.

Predictions run on the CUDA card; `--cpu` runs them on the host CPU instead.
A machine without CUDA refuses a prediction without `--cpu`, and refuses
`train` and `bench`, which run on the card only (tests call
`training.launch.run(job, device="cpu")` and `bench.main(device="cpu")`).

Coordinates: 'chr1:1000000-2000000' for region/del/dup/inv;
'chr1:1000000|chr2:2000000|+-' for break (two breakpoints + orientations).

    python -m orca_tpu_torch.cli region chr9:94904000-126904000 out/
"""

from __future__ import annotations

import argparse
import os
import pickle
import re
import sys

PREDICTION_MODES = ("region", "del", "dup", "inv", "break")

# subcommands whose arguments are parsed but whose work waits for a ROADMAP
# item of the port
_NOT_PORTED = {
    "certify": ("A17", "certification against the reference's modules"),
}


def _parse_coordinate(s: str):
    chrstr, coordstr = s.split(":")
    chrstr = "chr" + chrstr.replace("chr", "")
    start, end = coordstr.replace(",", "").split("-")
    return chrstr, int(start), int(end)


def _parse_breakpoint(s: str):
    p1, p2, orient = s.split("|")
    chr1, pos1 = p1.split(":")
    chr2, pos2 = p2.split(":")
    return (
        "chr" + chr1.replace("chr", ""), int(pos1.replace(",", "")),
        "chr" + chr2.replace("chr", ""), int(pos2.replace(",", "")),
        orient[0], orient[1],
    )


def build_parser() -> argparse.ArgumentParser:
    """The JAX package's parser (subcommands, options, defaults and
    choices), under this package's name."""
    parser = argparse.ArgumentParser(
        prog="orca-tpu-torch",
        description="multiscale genome interaction prediction on a CUDA card",
    )
    parser.add_argument("--version", action="version",
                        version="orca-tpu-torch 0.1.0")
    sub = parser.add_subparsers(dest="command", required=True)

    for mode in PREDICTION_MODES:
        p = sub.add_parser(mode, help=f"{mode} prediction")
        p.add_argument("coordinate")
        p.add_argument("output_dir")
        p.add_argument("--show-genes", action="store_true")
        p.add_argument("--show-tracks", action="store_true")
        p.add_argument("--use-256m", "--256m", dest="use_256m",
                       action="store_true", help="use 32-256Mb models")
        p.add_argument("--coor-filename", action="store_true",
                       help="include coordinate in output filenames")
        p.add_argument("--model-dir", default=None)
        p.add_argument("--resource-dir", default=None)
        p.add_argument("--no-target", action="store_true",
                       help="skip observed micro-C retrieval")
        p.add_argument("--seq-shards", type=int, default=1,
                       help="shard the encoder sequence axis over this many "
                       "devices")
        p.add_argument("--assembly", default="hg38",
                       choices=["hg38", "GRCh38", "hg19", "GRCh37"],
                       help="genome assembly for the coordinates (the "
                       "reference auto-detects hg19, orca_predict.py:"
                       "158-175; here it is explicit)")
        p.add_argument("--cpu", action="store_true",
                       help="run on the host CPU (the reference's --nocuda) "
                       "instead of the CUDA card; fine for a few "
                       "predictions, slow for screens")

    p = sub.add_parser("build-genome", help="FASTA -> code memmap")
    p.add_argument("fasta")
    p.add_argument("memmap")

    p = sub.add_parser("convert", help="torch statedicts -> bundle pickle")
    p.add_argument("family", choices=["32m", "1m", "256m", "leukemia"])
    p.add_argument("name", help="h1esc | hff | hctnoc | leukemiaA | leukemiaB")
    p.add_argument("out")
    p.add_argument("--model-dir", default=None)
    p.add_argument("--resource-dir", default=None)

    p = sub.add_parser(
        "expectation",
        help="expectation files from a cooltools expected TSV or directly "
             "from a cooler/mcool (no cooltools needed)",
    )
    p.add_argument("source", help="TSV path, or a cooler URI "
                                  "(x.cool / x.mcool::/resolutions/4000)")
    p.add_argument("resolution", type=int, nargs="?", default=None,
                   help="bin size (required for TSV input; read from the "
                        "file for cooler input)")
    p.add_argument("--out-prefix", default=None)

    p = sub.add_parser("bench", help="run the standard benchmark on the "
                       "CUDA card: one JSON line (ORCA_BENCH_* variables)")

    p = sub.add_parser(
        "serve",
        help="warm prediction server: keep one process (and its models on "
        "the card) alive, reading prediction commands from stdin",
    )
    p.add_argument("--model-dir", default=None)
    p.add_argument("--resource-dir", default=None)
    p.add_argument("--seq-shards", type=int, default=1)
    p.add_argument(
        "--prewarm", choices=["32M", "256M"], action="append", default=None,
        help="load the family and run one request on each of its models "
        "before READY, so the first client command runs at steady-state "
        "speed; repeatable",
    )

    p = sub.add_parser(
        "train",
        help="launch a training stage on the CUDA card",
    )
    p.add_argument("stage", choices=["a", "b", "c"],
                   help="a: 1Mb Net; b: 1-32Mb Encoder2+decoders; "
                   "c: 32-256Mb Encoder3+decoders")
    p.add_argument("--config", required=True,
                   help="TrainJob JSON (data paths, holdouts, hparams)")
    p.add_argument("--workdir", default=None)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--swa", action="store_true", default=None,
                   help="stochastic weight averaging (stage a)")
    p.add_argument("--workers", type=int, default=None,
                   help="prefetch loader workers")
    p.add_argument("--mesh", default=None,
                   help="device mesh, e.g. 'data=4,seq=2'")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--no-resume", action="store_true")

    p = sub.add_parser(
        "certify",
        help="checkpoint parity report vs the reference implementation "
        "(not ported yet: ROADMAP A17)",
    )
    p.add_argument("reference", help="path to a jzhoulab/orca checkout")
    p.add_argument("--model-dir", default=None)
    p.add_argument("--resource-dir", default=None)
    p.add_argument("--names", default="h1esc,hff")
    p.add_argument("--families", default="32m",
                   help="comma list of 32m,1m,256m")
    p.add_argument("--atol", type=float, default=2e-3)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="bfloat16 = serving-precision tolerance report")
    p.add_argument("--synthetic", action="store_true",
                   help="full-geometry parity on random-init weights "
                        "(no released checkpoints/resources needed)")
    p.add_argument("--out", default=None, help="write JSON report here")
    return parser


def _device(args) -> str:
    """The device a prediction command runs on: the card unless --cpu."""
    return "cpu" if args.cpu else "cuda"


def _set_seq_shards(args, parser, meshes=None):
    """--seq-shards n: set the inference mesh to n sequence shards over the
    devices a command runs on (every CUDA card, or the one CPU under
    --cpu); a count that does not divide them is the parser's error.
    `meshes` (the warm server's) keeps one mesh per count and device, so
    the parameter copies a mesh caches serve every later command."""
    from orca_tpu_torch.parallel.mesh import (
        inference_mesh_from_seq_shards,
        set_inference_mesh,
    )

    device = "cpu" if getattr(args, "cpu", False) else "cuda"
    key = (args.seq_shards, device)
    mesh = meshes.get(key) if meshes is not None else None
    if mesh is None:
        try:
            mesh = inference_mesh_from_seq_shards(args.seq_shards,
                                                  device_type=device)
        except (ValueError, RuntimeError) as e:
            parser.error(str(e))
        if meshes is not None:
            meshes[key] = mesh
    set_inference_mesh(mesh)


def _convert(args) -> int:
    """A family's statedict loader on the host CPU (conversion is an offline
    step and the pickle holds numpy), then `zoo.save_bundle`."""
    from orca_tpu_torch.models import zoo
    from orca_tpu_torch.utils.config import get_config

    cfg = get_config()
    model_dir = args.model_dir or cfg.model_dir
    resource_dir = args.resource_dir or cfg.resource_dir
    loader = {
        "32m": zoo.load_32m_bundle,
        "1m": zoo.load_1m_bundle,
        "256m": zoo.load_256m_bundle,
        "leukemia": zoo.load_leukemia_bundle,
    }[args.family]
    bundle = loader(model_dir, resource_dir, args.name, device="cpu")
    zoo.save_bundle(bundle, args.out)
    print(f"wrote {args.out}")
    return 0


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.command in _NOT_PORTED:
        item, what = _NOT_PORTED[args.command]
        parser.error(f"`{args.command}` needs {what}, which is not ported to "
                     f"orca_tpu_torch yet (ROADMAP {item}); the JAX package's "
                     f"`orca-tpu {args.command}` runs it")

    if args.command == "build-genome":
        from orca_tpu_torch.data.genome import MemmapGenome

        if not os.path.exists(args.fasta):
            parser.error(f"FASTA file not found: {args.fasta}")
        MemmapGenome.build(args.fasta, args.memmap)
        print(f"wrote {args.memmap} (+ .json index)")
        return 0

    if args.command == "convert":
        return _convert(args)

    if args.command == "expectation":
        src = args.source
        if "::" in src or src.endswith((".cool", ".mcool")):
            from orca_tpu_torch.data.expectation import (
                process_expectation_cooler,
            )

            prefix = args.out_prefix or src.split("::")[0]
            _, _, written = process_expectation_cooler(src, prefix)
            print("wrote " + " ".join(written))
            return 0
        if args.resolution is None:
            parser.error("TSV input needs the resolution argument")
        from orca_tpu_torch.data.expectation import process_expectation_tsv

        process_expectation_tsv(src, args.resolution,
                                out_prefix=args.out_prefix)
        print(f"wrote {args.out_prefix or src}.npy / .mono.npy")
        return 0

    if args.command == "serve":
        return _serve(args, parser)

    if args.command == "train":
        return _train(args, parser)

    if args.command == "bench":
        import torch

        if not torch.cuda.is_available():
            parser.error("CUDA is not available: the benchmark runs on the "
                         "CUDA card")
        from orca_tpu_torch import bench

        bench.main()
        return 0

    # prediction modes
    if not args.cpu:
        import torch

        if not torch.cuda.is_available():
            parser.error("CUDA is not available: predictions run on the "
                         "CUDA card; pass --cpu to run on the host CPU")
    if args.seq_shards > 1:
        _set_seq_shards(args, parser)

    # validate the coordinate before loading gigabytes of resources
    try:
        if args.command == "break":
            _parse_breakpoint(args.coordinate)
        else:
            _parse_coordinate(args.coordinate)
    except (ValueError, IndexError):
        parser.error(
            f"could not parse coordinate {args.coordinate!r} — expected "
            "'chr1:1000000-2000000' (or "
            "'chr1:1000000|chr2:2000000|+-' for break)"
        )

    return _run_prediction(args, parser)


def _train(args, parser) -> int:
    """The JAX package's `train` action on the CUDA cards: the TrainJob JSON
    with the flags as overrides, then `training.launch.run` (which starts
    one process per 'data' index of a mesh)."""
    import torch

    from orca_tpu_torch.training.launch import TrainJob, mesh_sizes, run

    if not torch.cuda.is_available():
        parser.error("CUDA is not available: training runs on the CUDA card")
    job = TrainJob.from_json(
        args.config,
        stage=args.stage,
        workdir=args.workdir,
        max_steps=args.max_steps,
        use_swa=args.swa,
        num_workers=args.workers,
        seed=args.seed,
        mesh=args.mesh,
    )
    try:
        mesh_sizes(job)
    except ValueError as e:
        parser.error(f"{args.config}: {e}")
    if args.no_resume:
        job.resume = False
    metrics = run(job)
    if metrics:
        print({k: float(v) for k, v in metrics.items()})
    return 0


def _serve(args, parser):
    """Warm server loop: one process keeps its models on the card, so every
    command pays only its own work. Reads one prediction command per stdin
    line in CLI syntax, e.g.:

        region chr9:94904000-126904000 /tmp/out --no-target
        dup chr1:1000000-2000000 /tmp/out2

    and prints READY / OK / ERR lines on stdout. Resources load once per
    model family, directories and device; with --prewarm each model of the
    family runs one request before READY (the first request of a process
    pays set-up that later ones do not). The server's --seq-shards sets the
    inference mesh for every command; a command's own --seq-shards sets it
    for that command alone, from one mesh kept per count and device.
    """
    import shlex

    from orca_tpu_torch.parallel.mesh import (
        get_inference_mesh,
        set_inference_mesh,
    )
    from orca_tpu_torch.predict.resources import load_resources

    meshes = {}
    if args.seq_shards > 1:
        _set_seq_shards(args, parser, meshes)

    # Surface parser.error messages (bad flags, missing resources) to the
    # client as ERR lines instead of a bare SystemExit.
    def _raise_parser_error(msg):
        raise RuntimeError(msg)

    parser.error = _raise_parser_error

    res_cache = {}
    # As in the JAX package, a prewarm failure ends the server before READY.
    for fam in args.prewarm or ():
        from orca_tpu_torch.models.zoo import Model256MBundle, ModelBundle
        from orca_tpu_torch.predict.multiscale import (
            warmup_cascade_32m,
            warmup_cascade_256m,
        )

        key = (fam, args.model_dir, args.resource_dir, "cuda")
        res_cache[key] = load_resources(
            models=[fam], model_dir=args.model_dir,
            resource_dir=args.resource_dir, device="cuda",
        )
        dt = 0.0
        for bundle in res_cache[key].models.values():
            if isinstance(bundle, Model256MBundle):
                dt += warmup_cascade_256m(bundle, device="cuda")
            elif isinstance(bundle, ModelBundle):
                dt += warmup_cascade_32m(bundle, device="cuda")
        print(f"WARM {fam} {dt:.1f}s", flush=True)
    print("READY", flush=True)
    for line in sys.stdin:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if line in ("quit", "exit"):
            break
        try:
            argv = shlex.split(line)
            if argv[0] not in PREDICTION_MODES:
                raise ValueError(
                    f"unknown mode {argv[0]!r} (region|del|dup|inv|break)"
                )
            # server-level dirs are DEFAULTS; per-line flags win
            if args.model_dir and "--model-dir" not in argv:
                argv += ["--model-dir", args.model_dir]
            if args.resource_dir and "--resource-dir" not in argv:
                argv += ["--resource-dir", args.resource_dir]
            cmd_args = parser.parse_args(argv)
            server_mesh = get_inference_mesh()
            try:
                if cmd_args.seq_shards > 1:
                    _set_seq_shards(cmd_args, parser, meshes)
                fam = "256M" if cmd_args.use_256m else "32M"
                device = _device(cmd_args)
                key = (fam, cmd_args.model_dir, cmd_args.resource_dir, device)
                if key not in res_cache:
                    res_cache[key] = load_resources(
                        models=[fam], model_dir=cmd_args.model_dir,
                        resource_dir=cmd_args.resource_dir, device=device,
                    )
                _run_prediction(cmd_args, parser, res=res_cache[key])
            finally:
                set_inference_mesh(server_mesh)
            print("OK", flush=True)
        except SystemExit:
            print("ERR command rejected (see stderr)", flush=True)
        except Exception as e:  # noqa: BLE001 — server must not die
            print(f"ERR {type(e).__name__}: {e}", flush=True)
    return 0


def _run_prediction(args, parser, res=None):
    """Execute one prediction command on `_device(args)`; `res`
    (OrcaResources) may be passed in by the warm server loop to skip
    reloading."""
    from orca_tpu_torch.predict import pipelines
    from orca_tpu_torch.predict.resources import load_resources

    device = _device(args)
    window_radius = 128000000 if args.use_256m else 16000000
    if res is None:
        try:
            res = load_resources(
                models=["256M" if args.use_256m else "32M"],
                model_dir=args.model_dir, resource_dir=args.resource_dir,
                device=device,
            )
        except FileNotFoundError as e:
            parser.error(
                f"model/resource files missing ({e}). Place orca_<name>.bundle"
                " pickles (`zoo.save_bundle` of either package) in "
                "--model-dir and expectation/genome resources in "
                "--resource-dir."
            )
    try:
        genome = res.get_genome(args.assembly)
    except ValueError as e:
        parser.error(str(e))
    if genome is None:
        parser.error("no genome resources found (see --resource-dir)")

    if args.use_256m:
        models = res.bundles(["h1esc_256m", "hff_256m"])
        targets = (
            [res.targets.get("h1esc_256m"), res.targets.get("hff_256m")]
            if res.target_available and not args.no_target else None
        )
    else:
        models = res.bundles(["h1esc", "hff"])
        targets = (
            [res.targets.get("h1esc"), res.targets.get("hff")]
            if res.target_available and not args.no_target else None
        )
    model_labels = ["H1-ESC", "HFF"]

    os.makedirs(args.output_dir, exist_ok=True)
    suffix = (
        "_" + re.sub(r'[\\/*?:"<>|]', "_", args.coordinate)
        if args.coor_filename else ""
    )
    file_prefix = os.path.join(args.output_dir, "orca_pred" + suffix)
    common = dict(
        genome=genome, models=models, targets=targets, file=file_prefix,
        show_genes=args.show_genes, show_tracks=args.show_tracks,
        window_radius=window_radius, model_labels=model_labels,
        device=device,
    )

    if args.command == "region":
        chrom, start, end = _parse_coordinate(args.coordinate)
        outputs = pipelines.process_region(chrom, start, end, **common)
    elif args.command == "del":
        chrom, start, end = _parse_coordinate(args.coordinate)
        outputs = pipelines.process_del(chrom, start, end, **common)
    elif args.command == "dup":
        chrom, start, end = _parse_coordinate(args.coordinate)
        outputs = pipelines.process_dup(chrom, start, end, **common)
    elif args.command == "inv":
        chrom, start, end = _parse_coordinate(args.coordinate)
        outputs = pipelines.process_inv(chrom, start, end, **common)
    elif args.command == "break":
        chr1, pos1, chr2, pos2, o1, o2 = _parse_breakpoint(args.coordinate)
        outputs = pipelines.process_single_breakpoint(
            chr1, pos1, chr2, pos2, o1, o2, **common
        )
    else:
        parser.error(f"unknown command {args.command}")

    with open(file_prefix + ".pkl", "wb") as f:
        pickle.dump(outputs, f)
    print(f"wrote {file_prefix}.pkl")
    return 0


if __name__ == "__main__":
    sys.exit(main())
