"""The port's warm-server screen benchmark
(orca_tpu_torch/scripts/bench_serve_screen.py) against the JAX package's
scripts/bench_serve_screen.py, on the CPU (the port's server runs on the
card only):

  * the fixture loads through `load_resources` with every parameter equal
    to the bundles it saved, and its genome holds the JAX script's codes;
  * the warm-up command and the screen's commands equal the JAX script's
    (read from its source and evaluated);
  * the protocol against a stand-in server that prints WARM, READY and OK:
    the JSON line has the JAX script's keys plus `serve_plots` and the
    card's fields, each command's .pkl is kept; the server is torn down
    when a command fails and when this process gets SIGTERM;
  * `--plots record` starts the server through the module's own entry,
    whose recorder writes each plot's file name;
  * with matplotlib unimportable, `--plots pdf` fails before anything
    starts, naming `--plots record`.
"""

import ast
import json
import os
import pathlib
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from orca_tpu_torch.models import zoo
from orca_tpu_torch.predict import resources
from orca_tpu_torch.scripts import bench_serve_screen as bss
from orca_tpu_torch.utils.tree import tree_leaves
from test_torch_encoders import share_cpu_with_other_workers

share_cpu_with_other_workers()

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_SCRIPT = REPO / "scripts" / "bench_serve_screen.py"


def _jax_main():
    tree = ast.parse(JAX_SCRIPT.read_text())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def jax_commands(n_variants, out):
    """(warm-up command, screen commands) of the JAX script's main: its
    `send(f"region ...")` string and its `for i in range(n_variants)`
    loop, evaluated with `n_variants` and `out`."""
    main = _jax_main()
    warm = next(n.args[0] for n in ast.walk(main)
                if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id == "send" and isinstance(n.args[0],
                                                       ast.JoinedStr))
    loop = next(n for n in main.body if isinstance(n, ast.For)
                and ast.unparse(n.iter) == "range(n_variants)")
    env = {"n_variants": n_variants, "out": out, "cmds": []}
    exec(compile(ast.Module([loop], []), str(JAX_SCRIPT), "exec"), env)
    return eval(compile(ast.Expression(warm), str(JAX_SCRIPT), "eval"),
                env), env["cmds"]


def jax_field_keys():
    main = _jax_main()
    node = next(n for n in ast.walk(main) if isinstance(n, ast.Assign)
                and isinstance(n.targets[0], ast.Name)
                and n.targets[0].id == "fields")
    return {k.value for k in node.value.keys}


def test_commands_equal_the_jax_scripts():
    out = "/some/out"
    warm, cmds = jax_commands(10, out)
    assert bss.warmup_command(out) == warm
    assert bss.screen_commands(10, out) == cmds
    assert len(cmds) == 10 and cmds[0].startswith("dup chr8:16500000-")


def test_fixture_loads_through_load_resources(tmp_path):
    model_dir, resource_dir = bss.build_fixture(str(tmp_path))
    res = resources.load_resources(models=["32M"], model_dir=model_dir,
                                   resource_dir=resource_dir,
                                   dtype="float32", device="cpu")
    assert sorted(res.models) == ["h1esc", "hff"]
    for seed, name in ((0, "h1esc"), (1, "hff")):
        want = zoo.fold_bundle(zoo.random_32m_bundle(seed, device="cpu"))
        got = res.models[name]
        for field in ("encoder", "pyramid", "decoders", "decoder_1pt"):
            g, w = (tree_leaves(getattr(b, field)) for b in (got, want))
            assert len(g) == len(w) > 0
            assert all(torch.equal(a, b) for a, b in zip(g, w)), (name, field)
        for lv in want.normmats:
            np.testing.assert_array_equal(got.normmats[lv], want.normmats[lv])
    assert res.genome.get_chr_lens() == [("chr8", bss.CHROM_BP),
                                         ("chr9", bss.CHROM_BP)]
    rng = np.random.RandomState(0)
    codes = rng.randint(0, 4, bss.CHROM_BP).astype(np.uint8)
    np.testing.assert_array_equal(res.genome._data()[:1000], codes[:1000])


STAND_IN = textwrap.dedent("""\
    import os, pickle, sys, time
    pid_file, mode = sys.argv[1], sys.argv[2]
    with open(pid_file, "w") as f:
        f.write(str(os.getpid()))
    print("loading", flush=True)
    print("WARM 32M 0.5s", flush=True)
    print("READY", flush=True)
    for line in sys.stdin:
        argv = line.split()
        if argv[0] == "quit":
            break
        if mode == "hang":
            time.sleep(600)
        if mode == "err":
            print("ERR ValueError: refused", flush=True)
            continue
        with open(os.path.join(argv[2], "orca_pred.pkl"), "wb") as f:
            pickle.dump(argv[0], f)
        print("wrote", flush=True)
        print("OK", flush=True)
""")


def _stand_in(tmp_path, mode):
    script = tmp_path / "stand_in_server.py"
    script.write_text(STAND_IN)
    pid_file = tmp_path / f"server_{mode}.pid"
    return [sys.executable, str(script), str(pid_file), mode], pid_file


def _gone(pid_file, timeout=20):
    """True when the process whose pid the stand-in wrote has ended."""
    pid = int(pid_file.read_text())
    t0 = time.time()
    while time.time() - t0 < timeout:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        time.sleep(0.1)
    return False


def _no_fixture(root):
    return os.path.join(root, "models"), os.path.join(root, "resources")


def test_main_against_a_stand_in_server(tmp_path, monkeypatch, capsys):
    argv, pid_file = _stand_in(tmp_path, "ok")
    monkeypatch.setattr(bss, "build_fixture", _no_fixture)
    got = []

    def argv_fn(model_dir, resource_dir, plots, out):
        got.append(bss.server_argv(model_dir, resource_dir, plots, out))
        return argv

    line = bss.main(3, plots="record", root=str(tmp_path / "root"),
                    device="cpu", argv_fn=argv_fn)
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == line
    assert set(line) == jax_field_keys() | {"serve_plots", "device",
                                            "power_limit_w"}
    assert line["serve_plots"] == "record" and line["device"] == "cpu"
    assert line["serve_prewarm_s"] == 0.5 and line["serve_n_variants"] == 3
    for key in ("serve_ready_s", "serve_first_command_s",
                "serve_seconds_per_variant"):
        assert line[key] > 0, key
    out = tmp_path / "root" / "out"
    assert sorted(os.listdir(out)) == ["000_region.pkl", "001_dup.pkl",
                                       "002_del.pkl", "003_dup.pkl"]
    # --plots record: the server runs through this module's recording entry
    assert got[0][1:5] == ["-m", bss.MODULE, "--serve-recording-plots",
                           str(out / bss.RECORDED_PLOTS)]
    assert got[0][5:] == ["serve", "--model-dir", str(tmp_path / "root" /
                                                      "models"),
                          "--resource-dir", str(tmp_path / "root" /
                                                "resources"),
                          "--prewarm", "32M"]
    assert _gone(pid_file)


def test_a_failed_command_tears_the_server_down(tmp_path):
    argv, pid_file = _stand_in(tmp_path, "err")
    out = tmp_path / "out"
    out.mkdir()
    with pytest.raises(RuntimeError, match="warm-up command: ERR"):
        bss.run_screen(argv, dict(os.environ), str(out), 2)
    assert _gone(pid_file)


def test_sigterm_tears_the_server_down(tmp_path):
    """The screen's process killed by SIGTERM (as `timeout` does) while
    its server works on a command: the server goes too."""
    argv, pid_file = _stand_in(tmp_path, "hang")
    out = tmp_path / "out"
    out.mkdir()
    code = ("import os, sys\n"
            "from orca_tpu_torch.scripts import bench_serve_screen as b\n"
            f"b.run_screen({argv!r}, dict(os.environ), {str(out)!r}, 2)\n")
    driver = subprocess.Popen([sys.executable, "-c", code], cwd=REPO)
    t0 = time.time()
    while not pid_file.exists() and time.time() - t0 < 60:
        time.sleep(0.1)
    time.sleep(0.5)  # READY read, the warm-up command sent
    driver.send_signal(signal.SIGTERM)
    assert driver.wait(timeout=60) == 143
    assert _gone(pid_file)


def test_recording_entry_records_plot_names(tmp_path, monkeypatch):
    from orca_tpu_torch import cli, viz
    from orca_tpu_torch.predict import pipelines

    for name in ("genomeplot", "genomeplot_256mb"):
        monkeypatch.setattr(viz, name, getattr(viz, name))

    def fake_main(argv):
        assert argv == ["serve", "--prewarm", "32M"]
        pipelines._maybe_plot({}, "o/orca_pred", ".alt", pipelines.WR32,
                              None)
        pipelines._maybe_plot({}, "o/orca_pred", "", pipelines.WR256, None)
        return 0

    monkeypatch.setattr(cli, "main", fake_main)
    record = tmp_path / "plots.txt"
    assert bss.serve_recording_plots(str(record),
                                     ["serve", "--prewarm", "32M"]) == 0
    assert record.read_text().split() == ["o/orca_pred.alt.pdf",
                                          "o/orca_pred.256m.pdf"]


def test_pdf_plots_without_matplotlib_name_the_option(monkeypatch):
    def no_fixture(root):
        raise AssertionError("the fixture was built")

    monkeypatch.setattr(bss, "build_fixture", no_fixture)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="--plots record"):
        bss.main(2, device="cpu")
