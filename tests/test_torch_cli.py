"""The port's command line (orca_tpu_torch/cli.py) against the JAX package's
(orca_tpu/cli.py), on the CPU.

  * the parsers: every subcommand, option, default and choice;
  * the coordinate parsers: equal results, equal exception types;
  * `_run_prediction` in all five modes on both branches, with both
    packages' `load_resources` and `process_*` replaced by one recorder: the
    calls (the port's device aside) and the written .pkl bytes equal;
  * the serve loop of tests/test_launch.py through both packages' `main`:
    equal output lines and resource loads, with and without --prewarm;
  * `build-genome` and `expectation`: byte-equal files;
  * `convert` on one directory of reference-format statedicts: the bundles
    both packages pickle are equal;
  * the device rule: no CUDA and no --cpu refuses a prediction before any
    model runs; the unported subcommands name their ROADMAP item;
  * --seq-shards sets the inference mesh in `serve`, at start-up and per
    command, and a count that does not divide the devices is refused with
    the JAX package's message.
"""

import argparse
import io
import sys

import numpy as np
import pytest
import torch

from orca_tpu import cli as jcli
from orca_tpu.models import zoo as jzoo
from orca_tpu.predict import multiscale as jms
from orca_tpu.predict import pipelines as jpipe
from orca_tpu.predict import resources as jres
from orca_tpu_torch import cli as tcli
from orca_tpu_torch.models import zoo as tzoo
from orca_tpu_torch.predict import multiscale as tms
from orca_tpu_torch.predict import pipelines as tpipe
from orca_tpu_torch.predict import resources as tres
from test_torch_convert import (bundles_equal, write_model_files,
                                write_resource_files)
from test_torch_retrieval import cooler_path  # noqa: F401  (fixture)

PACKAGES = {"jax": (jcli, jpipe, jres, jms, jzoo),
            "torch": (tcli, tpipe, tres, tms, tzoo)}
PROCESS = {"region": "process_region", "del": "process_del",
           "dup": "process_dup", "inv": "process_inv",
           "break": "process_single_breakpoint"}


def jax_parser(monkeypatch):
    """The JAX package's parser, as its `main` builds it."""
    with monkeypatch.context() as m:
        m.setattr(jcli, "_serve", lambda args, parser: parser)
        return jcli.main(["serve"])


def describe(parser):
    """Every option of a parser and of its subparsers, in order, as plain
    data (help texts and the version string aside)."""
    out = []
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            out.append(("<sub>", a.dest, a.required,
                        [(name, describe(p)) for name, p in a.choices.items()]))
        elif isinstance(a, (argparse._HelpAction, argparse._VersionAction)):
            out.append((type(a).__name__, tuple(a.option_strings)))
        else:
            out.append((type(a).__name__, tuple(a.option_strings), a.dest,
                        a.nargs, a.const, a.default, a.type, a.choices,
                        a.required))
    return out


def test_parser_equal(monkeypatch):
    want = describe(jax_parser(monkeypatch))
    got = describe(tcli.build_parser())
    assert got == want
    subs = [name for name, _ in want[-1][3]]
    assert subs == ["region", "del", "dup", "inv", "break", "build-genome",
                    "convert", "expectation", "bench", "serve", "train",
                    "certify"]
    assert tcli.build_parser().prog == "orca-tpu-torch"


COORDS = ["chr1:1000000-2000000", "1:1,000,000-2,000,000", "chrX:5-10",
          "X:0-1", "chr1:1,000-2,000,000", "chr1:100", "chr1-100-200",
          "chr1:a-b", "chr1:1-2-3", "", "chr1:1000000|chr2:2000000|+-"]
BREAKS = ["chr1:1000000|chr2:2000000|+-", "1:1,000|X:2,000,000|-+",
          "chr1:5|chr1:10|++", "chr1:5|chr2:10", "chr1:5|chr2:10|+",
          "chr1:x|chr2:10|+-", "chr1|chr2:10|+-", "chr1:5-6|chr2:10|+-",
          "chr1:1000000-2000000"]


def _outcome(fn, s):
    try:
        return fn(s)
    except Exception as e:  # noqa: BLE001 — the type is what is compared
        return type(e)


@pytest.mark.parametrize("s", COORDS)
def test_parse_coordinate_equal(s):
    assert (_outcome(tcli._parse_coordinate, s)
            == _outcome(jcli._parse_coordinate, s))


@pytest.mark.parametrize("s", BREAKS)
def test_parse_breakpoint_equal(s):
    assert (_outcome(tcli._parse_breakpoint, s)
            == _outcome(jcli._parse_breakpoint, s))


class FakeResources:
    """Stands in for OrcaResources: tokens for the genome, bundles and
    targets."""

    target_available = True

    def __init__(self):
        self.targets = {k: f"T:{k}" for k in ("h1esc", "hff", "h1esc_256m",
                                              "hff_256m")}

    def get_genome(self, assembly="hg38"):
        if assembly in ("hg19", "GRCh37"):
            raise ValueError("hg19 requested but not present")
        return f"GENOME:{assembly}"

    def bundles(self, names):
        return [f"BUNDLE:{n}" for n in names]


class Recorder:
    """One package's load_resources and process_* functions."""

    def __init__(self, port):
        self.port = port
        self.calls = []

    def load_resources(self, **kw):
        if self.port:
            assert kw.pop("device") == "cpu"
        self.calls.append(("load_resources", (), kw))
        return FakeResources()

    def process(self, name):
        def run(*args, **kw):
            if self.port:
                assert kw.pop("device") == "cpu"
            self.calls.append((name, args, kw))
            return [{"process": name, "args": args,
                     "file": kw["file"], "n": len(self.calls)}]
        return run


def _patch(monkeypatch, pkg, rec):
    _, pipe, res, _, _ = PACKAGES[pkg]
    monkeypatch.setattr(res, "load_resources", rec.load_resources)
    for name in PROCESS.values():
        monkeypatch.setattr(pipe, name, rec.process(name))


CLI_CASES = [
    ["region", "chr9:94,904,000-126,904,000"],
    ["del", "1:1000000-2000000", "--no-target"],
    ["dup", "chrX:5000000-5800000", "--coor-filename", "--show-genes"],
    ["inv", "chr2:30000000-31000000", "--assembly", "GRCh38",
     "--show-tracks"],
    ["break", "chr1:1,000,000|chr2:2,000,000|+-", "--coor-filename"],
]


@pytest.mark.parametrize("branch", [[], ["--use-256m"]], ids=["32m", "256m"])
@pytest.mark.parametrize("case", CLI_CASES, ids=[c[0] for c in CLI_CASES])
def test_run_prediction_equal(case, branch, tmp_path, monkeypatch, capsys):
    """The same argv through both packages' parser and `_run_prediction`
    (with --cpu, which the port passes on as device='cpu' and the JAX
    package's `main` handles before): equal calls, equal .pkl bytes, equal
    printed lines."""
    out_dir = str(tmp_path / "out")
    argv = [*case[:2], out_dir, *case[2:], *branch, "--cpu",
            "--model-dir", "/m", "--resource-dir", "/r"]
    results = {}
    for pkg in ("jax", "torch"):
        cli = PACKAGES[pkg][0]
        parser = (jax_parser(monkeypatch) if pkg == "jax"
                  else tcli.build_parser())
        rec = Recorder(port=pkg == "torch")
        _patch(monkeypatch, pkg, rec)
        assert cli._run_prediction(parser.parse_args(argv), parser) == 0
        monkeypatch.undo()
        (pkl,) = list((tmp_path / "out").glob("*.pkl"))
        results[pkg] = (rec.calls, pkl.name, pkl.read_bytes(),
                        capsys.readouterr().out)
        pkl.unlink()
    assert results["torch"] == results["jax"]
    calls = results["jax"][0]
    assert [c[0] for c in calls] == ["load_resources", PROCESS[case[0]]]
    kw = calls[1][2]
    assert kw["window_radius"] == (128_000_000 if branch else 16_000_000)
    assert kw["targets"] is None if "--no-target" in case else kw["targets"]


def test_run_prediction_reports_missing_genome(tmp_path, monkeypatch):
    """An assembly the resources lack is a parser error in both packages."""
    argv = ["region", "chr1:1-2", str(tmp_path), "--assembly", "hg19",
            "--cpu"]
    for pkg in ("jax", "torch"):
        cli = PACKAGES[pkg][0]
        parser = (jax_parser(monkeypatch) if pkg == "jax"
                  else tcli.build_parser())
        _patch(monkeypatch, pkg, Recorder(port=pkg == "torch"))
        with pytest.raises(SystemExit) as e:
            cli._run_prediction(parser.parse_args(argv), parser)
        assert e.value.code == 2
        monkeypatch.undo()


SERVE_INPUT = (
    "# comment\n"
    "region chr1:1000-2000 /tmp/o1 --no-target\n"
    "dup chr1:1000-2000 /tmp/o2\n"
    "region chr1:1000-2000 /tmp/o3 --model-dir /other/models\n"
    "frobnicate chr1:1-2 /tmp/o4\n"
    "del chr1:1000-2000 /tmp/o5 --bogus-flag\n"
    "region chr1:1000-2000 /tmp/o6 --use-256m\n"
    "\n"
    "quit\n"
    "region chr1:1000-2000 /tmp/never\n"
)


def _serve(pkg, argv, stdin, monkeypatch, capsys):
    """One package's `main(['serve', ...])` with `_run_prediction`,
    `load_resources` and the warm-ups recorded; returns (stdout lines,
    loads, calls, warm-ups)."""
    cli, _, res, ms, zoo = PACKAGES[pkg]
    calls, loads, warms = [], [], []

    def load(**kw):
        loads.append(kw)
        fake = FakeResources()
        fake.models = {
            n: zoo.ModelBundle(name=n, encoder={}, pyramid={}, decoders={},
                               decoder_1pt=None, normmats={}, epss={})
            for n in ("h1esc", "hff")}
        fake.tag = f"RES{len(loads)}"
        return fake

    def warm(bundle, **kw):
        warms.append((bundle.name, kw))
        return 1.25

    monkeypatch.setattr(cli, "_run_prediction",
                        lambda args, parser, res=None: calls.append(
                            (args.command, args.coordinate, res.tag)))
    monkeypatch.setattr(res, "load_resources", load)
    monkeypatch.setattr(ms, "warmup_cascade_32m", warm)
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    assert cli.main(["serve", *argv]) == 0
    monkeypatch.undo()
    out = capsys.readouterr().out
    return out.splitlines(), loads, calls, warms


@pytest.mark.parametrize("argv", [[], ["--prewarm", "32M"],
                                  ["--model-dir", "/srv/models",
                                   "--prewarm", "32M"]],
                         ids=["plain", "prewarm", "prewarm_server_dirs"])
def test_serve_equal(argv, monkeypatch, capsys):
    """The serve scenario of tests/test_launch.py (plus a rejected flag, a
    256 Mb command and a line after quit) through both packages: the same
    READY/WARM/OK/ERR lines, loads and dispatches; the port's loads name the
    card."""
    want = _serve("jax", argv, SERVE_INPUT, monkeypatch, capsys)
    got = _serve("torch", argv, SERVE_INPUT, monkeypatch, capsys)
    lines, loads, calls, warms = want
    assert got[0] == lines
    assert got[1] == [dict(kw, device="cuda") for kw in loads]
    assert got[2] == calls
    assert [w[0] for w in got[3]] == [w[0] for w in warms]
    assert all(kw == {"device": "cuda"} for _, kw in got[3])
    assert [c[0] for c in calls] == ["region", "dup", "region", "region"]
    assert lines.count("OK") == 4
    assert sum(line.startswith("ERR") for line in lines) == 2
    if "--prewarm" in argv:
        assert lines[:2] == ["WARM 32M 2.5s", "READY"]
        assert [w[0] for w in warms] == ["h1esc", "hff"]
        # the prewarmed resources serve the 32 Mb commands
        assert calls[0][2] == calls[1][2] == "RES1"
    else:
        assert lines[0] == "READY" and warms == []
    if "--model-dir" in argv:
        assert all(kw["model_dir"] in ("/srv/models", "/other/models")
                   for kw in loads)


def test_serve_per_line_cpu_loads_for_the_cpu(monkeypatch, capsys):
    """In the port a per-line --cpu reaches the prediction: the resources
    are loaded again, for the CPU, and cached per device."""
    lines, loads, calls, _ = _serve(
        "torch", [],
        "region chr1:1-2 /tmp/a\nregion chr1:1-2 /tmp/b --cpu\n"
        "dup chr1:1-2 /tmp/c --cpu\n", monkeypatch, capsys)
    assert lines == ["READY", "OK", "OK", "OK"]
    assert [kw["device"] for kw in loads] == ["cuda", "cpu"]
    assert [c[2] for c in calls] == ["RES1", "RES2", "RES2"]


def test_serve_seq_shards_names_a16(monkeypatch, capsys):
    """--seq-shards in `serve` (it no longer names ROADMAP A16): the
    server's count sets the inference mesh for every command, a command's
    own count for that command alone, one mesh kept per count (so its
    parameter copies outlive the command), and a count that does not divide
    the devices is refused with the JAX package's message: as an ERR line
    for a command, as the parser's error at start-up. Without CUDA the
    server's mesh over the cards is refused too."""
    from orca_tpu_torch.parallel import mesh as tmesh

    monkeypatch.setattr(tmesh, "_INFERENCE_MESH", None)
    seen = []
    monkeypatch.setattr(tcli, "_run_prediction",
                        lambda args, parser, res=None: seen.append(
                            tmesh.get_inference_mesh()))
    monkeypatch.setattr(tres, "load_resources", lambda **kw: "RES")
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "region chr1:1-2 /tmp/a --seq-shards 2 --cpu\nquit\n"))
    assert tcli.main(["serve"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == ["READY", "ERR RuntimeError: seq_shards=2 does not "
                     "divide 1 devices"]
    assert seen == []
    with pytest.raises(SystemExit):
        tcli.main(["serve", "--seq-shards", "2"])
    assert "CUDA is not available" in capsys.readouterr().err

    monkeypatch.setattr(tmesh, "local_devices",
                        lambda device_type="cuda": [torch.device("cpu")] * 4)
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "region chr1:1-2 /tmp/a\n"
        "region chr1:1-2 /tmp/b --seq-shards 4\n"
        "region chr1:1-2 /tmp/c --seq-shards 3\n"
        "region chr1:1-2 /tmp/d\n"
        "region chr1:1-2 /tmp/e --seq-shards 4\n"
        "region chr1:1-2 /tmp/f --seq-shards 2\nquit\n"))
    assert tcli.main(["serve", "--seq-shards", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == ["READY", "OK", "OK", "ERR RuntimeError: seq_shards=3 "
                     "does not divide 4 devices", "OK", "OK", "OK"]
    assert [m.shape["seq"] for m in seen] == [2, 4, 2, 4, 2]
    assert seen[0] is seen[2] is seen[4] is tmesh.get_inference_mesh()
    assert seen[1] is seen[3]
    tmesh.set_inference_mesh(None)
    with pytest.raises(SystemExit):
        tcli.main(["serve", "--seq-shards", "3"])
    assert ("seq_shards=3 does not divide 4 devices"
            in capsys.readouterr().err)


def _fasta(path):
    rng = np.random.RandomState(0)
    letters = np.array(list("ACGTacgtN"))
    with open(path, "w") as f:
        for name, n in (("chr1", 10_007), ("chr2", 5_003), ("chrM", 61)):
            seq = "".join(letters[rng.randint(0, 9, n)])
            cut, run = n // 5, n // 4
            seq = seq[:cut] + "N" * run + seq[cut + run:]
            f.write(f">{name} synthetic\n")
            f.writelines(seq[i : i + 70] + "\n" for i in range(0, n, 70))


def test_build_genome_equal(tmp_path, capsys):
    fasta = str(tmp_path / "toy.fa")
    _fasta(fasta)
    outs = {}
    for pkg in ("jax", "torch"):
        path = str(tmp_path / f"{pkg}.codes.mmap")
        assert PACKAGES[pkg][0].main(["build-genome", fasta, path]) == 0
        printed = capsys.readouterr().out.replace(path, "<memmap>")
        with open(path, "rb") as f, open(path + ".json", "rb") as g:
            outs[pkg] = (f.read(), g.read(), printed)
    assert outs["torch"] == outs["jax"]
    assert len(outs["jax"][0]) == 10_007 + 5_003 + 61
    with pytest.raises(SystemExit):
        tcli.main(["build-genome", str(tmp_path / "missing.fa"),
                   str(tmp_path / "x.mmap")])


def _expected_tsv(path, res):
    """A cooltools expected TSV over two regions, with a .trans sibling."""
    rng = np.random.RandomState(1)
    n = 300
    with open(path, "w") as f:
        f.write("region\tdiag\tn_valid\tcount.sum\tbalanced.sum\n")
        for region in ("chr1", "chr2"):
            for d in range(n):
                nv = max(0, 400 - d - rng.randint(0, 3))
                bs = nv * np.exp(-1.1 * np.log1p(d) - 2.0) * rng.uniform(
                    0.8, 1.2)
                f.write(f"{region}\t{d}\t{nv}\t0\t{bs if nv else ''}\n")
    with open(path + ".trans", "w") as f:
        f.write("region1\tregion2\tn_valid\tcount.sum\tbalanced.sum\n")
        f.write(f"chr1\tchr2\t{160000}\t0\t{3.5}\n")
        f.write(f"chr1\tchrX\t{80000}\t0\t\n")
    return res


def _npys(prefix):
    out = {}
    for ext in (".npy", ".mono.npy", ".trans.npy"):
        try:
            with open(prefix + ext, "rb") as f:
                out[ext] = f.read()
        except FileNotFoundError:
            pass
    return out


def test_expectation_tsv_equal(tmp_path, capsys):
    """The TSV path at 40 kb (raw below 40 diagonals, both lowess scales
    above, the tricube fallback without statsmodels) and its .trans
    sibling."""
    tsv = str(tmp_path / "expected.tsv")
    res = _expected_tsv(tsv, 40_000)
    outs = {}
    for pkg in ("jax", "torch"):
        prefix = str(tmp_path / pkg)
        assert PACKAGES[pkg][0].main(["expectation", tsv, str(res),
                                      "--out-prefix", prefix]) == 0
        outs[pkg] = (_npys(prefix),
                     capsys.readouterr().out.replace(prefix, "<prefix>"))
    assert outs["torch"] == outs["jax"]
    assert sorted(outs["jax"][0]) == [".mono.npy", ".npy", ".trans.npy"]
    with pytest.raises(SystemExit):
        tcli.main(["expectation", tsv])


def test_expectation_cooler_equal(cooler_path, tmp_path, capsys):  # noqa: F811
    outs = {}
    for pkg in ("jax", "torch"):
        prefix = str(tmp_path / pkg)
        assert PACKAGES[pkg][0].main(["expectation", cooler_path,
                                      "--out-prefix", prefix]) == 0
        outs[pkg] = (_npys(prefix),
                     capsys.readouterr().out.replace(prefix, "<prefix>"))
    assert outs["torch"] == outs["jax"]
    assert sorted(outs["jax"][0]) == [".mono.npy", ".npy", ".trans.npy"]


def test_prediction_without_cuda_needs_cpu(tmp_path, monkeypatch, capsys):
    """No CUDA and no --cpu: the prediction is refused before resources
    load or a model runs; --cpu reaches `_run_prediction` with the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    seen = []
    monkeypatch.setattr(tcli, "_run_prediction",
                        lambda args, parser: seen.append(args.cpu) or 0)
    for mode, coord in (("region", "chr1:1-2"), ("break", "chr1:1|chr2:2|+-")):
        with pytest.raises(SystemExit) as e:
            tcli.main([mode, coord, str(tmp_path)])
        assert e.value.code == 2
        assert "CUDA is not available" in capsys.readouterr().err
    assert seen == []
    assert tcli.main(["region", "chr1:1-2", str(tmp_path), "--cpu"]) == 0
    assert seen == [True]
    with pytest.raises(SystemExit):  # a malformed coordinate, before loading
        tcli.main(["region", "chr1-1-2", str(tmp_path), "--cpu"])
    assert "could not parse coordinate" in capsys.readouterr().err
    assert seen == [True]


@pytest.fixture(scope="module")
def statedict_dirs(tmp_path_factory):
    """(model dir, resource dir) of reference-format statedicts for the
    h1esc and hff 32 Mb models and the h1esc 256 Mb model, and the
    expectation files."""
    root = tmp_path_factory.mktemp("statedicts")
    dirs = str(root / "models"), str(root / "resources")
    write_model_files(dirs[0], ["h1esc", "hff", "h1esc_256m"], seed=1)
    write_resource_files(dirs[1])
    return dirs


@pytest.mark.parametrize("family,name", [("1m", "hff"), ("256m", "h1esc")])
def test_convert_equal(statedict_dirs, family, name, tmp_path, capsys):
    """Both packages' `convert` on one directory: the same line printed and
    pickles whose bundles are equal (parameters leaf for leaf, backgrounds
    in value and dtype)."""
    model_dir, resource_dir = statedict_dirs
    said = {}
    for pkg in ("jax", "torch"):
        out = str(tmp_path / f"{pkg}.bundle")
        argv = ["convert", family, name, out, "--model-dir", model_dir,
                "--resource-dir", resource_dir]
        assert PACKAGES[pkg][0].main(argv) == 0
        said[pkg] = capsys.readouterr().out.replace(pkg, "<pkg>")
    assert said["torch"] == said["jax"] == f"wrote {tmp_path}/<pkg>.bundle\n"
    want = jzoo.load_bundle(str(tmp_path / "jax.bundle"))
    got = tzoo.load_bundle(str(tmp_path / "torch.bundle"), device="cpu",
                           dtype="float32")
    bundles_equal(got, want)


@pytest.mark.parametrize("argv,said", [
    # --seq-shards is ported: on the one CPU of --cpu a count of 2 fails
    # with the JAX package's message
    (["region", "chr1:1-2", "out", "--cpu", "--seq-shards", "2"],
     "seq_shards=2 does not divide 1 devices"),
    (["certify", "/ref", "--synthetic"], "ROADMAP A17"),
    # train --mesh is ported: without CUDA it fails as every `train` does
    (["train", "a", "--config", "job.json", "--mesh", "data=2"],
     "CUDA is not available"),
    (["bench"], "ROADMAP A14"),
], ids=["argv0-A16", "argv1-A17", "argv2-A16", "argv3-A14"])
def test_unported_paths_name_their_roadmap_item(argv, said, capsys,
                                                monkeypatch):
    from orca_tpu_torch.parallel import mesh as tmesh

    monkeypatch.setattr(tmesh, "_INFERENCE_MESH", None)
    with pytest.raises(SystemExit) as e:
        tcli.main(argv)
    assert e.value.code == 2
    assert said in capsys.readouterr().err
    assert tmesh.get_inference_mesh() is None


def test_warmup_32m_runs_one_request_on_cpu(monkeypatch):
    """The 32 Mb warm-up runs one real request on an all-zero packed window
    at its geometry and returns its seconds."""
    geom = tms.CascadeGeometry(1_024_000, 4000, 8)
    bundle = tzoo.fold_bundle(tzoo.random_32m_bundle(0, "cpu", nbins=256,
                                                     crop=8))
    seen = []
    real = tms._cascade_32mb

    def spy(bundle, geometry, seq, *args):
        seen.append((geometry, tuple(seq.shape), seq.dtype,
                     int(seq.sum()), seq.device.type))
        return real(bundle, geometry, seq, *args)

    monkeypatch.setattr(tms, "_cascade_32mb", spy)
    secs = tms.warmup_cascade_32m(bundle, geom, device="cpu")
    assert secs > 0
    assert seen == [(geom, (1, 1_024_000, 4), torch.uint8, 0, "cpu")]


def test_warmup_256m_runs_one_request_on_cpu(monkeypatch):
    """The 256 Mb warm-up runs one request (encoder step replaced by zeros)
    on an all-zero window with a flat background."""
    geom = tms.CascadeGeometry(8_192_000, 32_000, 8)
    bundle = tzoo.fold_256m_bundle(tzoo.random_256m_bundle(0, "cpu"))
    seen = []

    def encode(bundle, seq, mesh=None):
        seen.append((tuple(seq.shape), int(seq.sum())))
        return {lv: torch.zeros(2, geom.window_bp // (4000 * lv), 128)
                for lv in tzoo.LEVELS_256M}

    monkeypatch.setattr(tms, "_encode_256mb_fwd_rc", encode)
    assert tms.warmup_cascade_256m(bundle, geom, device="cpu") > 0
    assert seen == [((1, 8_192_000, 4), 0)]
