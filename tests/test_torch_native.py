"""The port's host codec (orca_tpu_torch/data/native.py over
csrc/orca_native.cpp) against the JAX package's (orca_tpu/data/native.py,
the oracle) and against the numpy path, bit for bit: every entry point, the
genome's native path, and the build's hygiene (racing builds, a changed
source, the JAX package's library left alone). Inputs are drawn from numpy
seeds. Skips only where no C++ compiler is on PATH."""

import ctypes
import hashlib
import pathlib
import shutil
import threading

import numpy as np
import pytest

from orca_tpu.data import genome as jgenome
from orca_tpu.data import native as jnative
from orca_tpu_torch.data import genome as tgenome
from orca_tpu_torch.data import native as tnative
from orca_tpu_torch.ops.kernels import build

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def compiler():
    if build.cxx_path() is None:
        pytest.skip("no C++ compiler (g++ or c++) on PATH")
    assert tnative.available() and jnative.available()
    tnative.reset_counts()


def numpy_onehot(codes, strand):
    enc = tgenome.codes_to_encoding(np.minimum(codes, 4))
    return np.ascontiguousarray(enc[::-1, ::-1] if strand == "-" else enc)


def assert_bit_equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# (length, codes drawn below this bound): N among the bases, and one case of
# codes above 4, which both codecs read as N
ONEHOT_CASES = [(0, 5), (1, 5), (1001, 5), (1 << 20, 5), (4099, 256)]


@pytest.mark.parametrize("strand", ["+", "-"])
@pytest.mark.parametrize("n,high", ONEHOT_CASES,
                         ids=[f"{n}bp-codes<{h}" for n, h in ONEHOT_CASES])
def test_codes_to_onehot(n, high, strand):
    codes = np.random.RandomState(n).randint(0, high, n).astype(np.uint8)
    got = tnative.codes_to_onehot(codes, rc=(strand == "-"))
    assert_bit_equal(got, jnative.codes_to_onehot(codes, rc=(strand == "-")))
    assert_bit_equal(got, numpy_onehot(codes, strand))
    name = "codes_to_onehot_rc" if strand == "-" else "codes_to_onehot"
    assert tnative.calls[name] == 1 and tnative.bytes_written[name] == 16 * n


# (starts, strands, window length) over a 3001 bp genome
GATHER_CASES = {
    "inside": ([0, 1000, 2001], [0, 1, 0], 1000),
    "negative-starts": ([-1, -250, -999], [0, 1, 1], 1000),
    "past-the-end": ([2500, 2999, 3001, 5000], [1, 0, 1, 0], 777),
    "longer-than-the-genome": ([-100, 0], [0, 1], 3333),
    "empty-window": ([3, -4], [1, 0], 0),
    "no-window": ([], [], 50),
}


def numpy_gather(genome, starts, strands, window_len):
    g = tgenome.CodeGenome({"g": genome})
    out = np.zeros((len(starts), window_len, 4), np.float32)
    for w, (s, r) in enumerate(zip(starts, strands)):
        out[w] = numpy_onehot(g.get_codes("g", s, s + window_len),
                              "-" if r else "+")
    return out


@pytest.mark.parametrize("case", GATHER_CASES)
def test_onehot_batch_gather(case):
    starts, strands, window_len = GATHER_CASES[case]
    genome = np.random.RandomState(7).randint(0, 5, 3001).astype(np.uint8)
    starts = np.array(starts, dtype=np.int64)
    strands = np.array(strands, dtype=np.uint8)
    got = tnative.onehot_batch_gather(genome, starts, strands, window_len)
    assert_bit_equal(got, jnative.onehot_batch_gather(genome, starts, strands,
                                                      window_len))
    assert_bit_equal(got, numpy_gather(genome, starts, strands, window_len))
    assert tnative.calls["onehot_batch_gather"] == 1
    assert tnative.bytes_written["onehot_batch_gather"] == got.nbytes


def _random_fasta(seed):
    """Three records of seeded bases: upper and lower case, N runs, other
    IUPAC letters, 60-column lines, description text, '\\r\\n' line ends in
    the second record."""
    rng = np.random.RandomState(seed)
    letters = np.array(list("ACGTacgtNnRY"))
    text = ""
    for i, (name, length) in enumerate((("chr1", 20_011), ("chr2", 9_000),
                                        ("chrUn_x", 61))):
        seq = "".join(letters[rng.randint(0, len(letters), length)])
        seq = "NNNNN" + seq[5:]
        end = "\r\n" if i == 1 else "\n"
        text += f">{name} record {i}\tlen={length}{end}"
        text += "".join(seq[j:j + 60] + end for j in range(0, length, 60))
    return text


FASTA_CASES = {
    "records": (_random_fasta(3), 4096),
    "crlf-header-keeps-its-cr": (">chr1\r\nACGTN\r\nacgtn\r\n>chr2 x\r\nGG\r\n",
                                 4096),
    "no-final-newline": (">a\nACGT\n>b\nTTGCA", 4096),
    "sequence-before-any-header": ("ACGT\n>a\nCC\n", 4096),
    "empty-file": ("", 4096),
    "max-chroms-overflow": (">a\nA\n>b\nC\n>c\nG\n", 2),
}


@pytest.mark.parametrize("case", FASTA_CASES)
def test_fasta_to_codes(case, tmp_path):
    text, max_chroms = FASTA_CASES[case]
    path = tmp_path / "genome.fa"
    path.write_bytes(text.encode())
    got = tnative.fasta_to_codes(str(path), max_chroms=max_chroms)
    want = jnative.fasta_to_codes(str(path), max_chroms=max_chroms)
    if case == "max-chroms-overflow":
        assert got is None and want is None
        assert tnative.calls["fasta_to_codes"] == 0
        return
    assert got[1] == want[1]
    assert_bit_equal(got[0], want[0])
    assert tnative.calls["fasta_to_codes"] == 1
    # the numpy reader: the same codes and records, less the headers' '\r'
    # and any sequence before the first header
    chroms = tgenome.read_fasta_codes(str(path))
    assert [(n.rstrip("\r"), e - s) for n, s, e in got[1]] == [
        (n, len(c)) for n, c in chroms.items()]
    skip = got[1][0][1] if got[1] else 0
    want_codes = (np.concatenate(list(chroms.values())) if chroms
                  else np.zeros(0, np.uint8))
    assert_bit_equal(got[0][skip:], want_codes)
    if case == "crlf-header-keeps-its-cr":
        assert [c[0] for c in got[1]] == ["chr1\r", "chr2"]


def test_fasta_to_codes_refuses_a_buffer_below_the_file(tmp_path):
    path = tmp_path / "genome.fa"
    path.write_text(">a\n" + "ACGT" * 100 + "\n")
    with pytest.raises(ValueError, match="max_size"):
        tnative.fasta_to_codes(str(path), max_size=100)
    assert tnative.fasta_to_codes(str(path), max_size=1000)[1] == [
        ("a", 0, 400)]


# (start, end) on a 5000 bp chromosome
WINDOWS = [(0, 5000), (1234, 3000), (-300, 700), (4500, 5500), (-100, 5100),
           (5010, 5020), (-50, -10), (17, 17)]


@pytest.mark.parametrize("strand", ["+", "-"])
@pytest.mark.parametrize("window", WINDOWS, ids=[f"{s}:{e}" for s, e in WINDOWS])
def test_genome_takes_the_native_path(window, strand):
    codes = np.random.RandomState(11).randint(0, 5, 5000).astype(np.uint8)
    start, end = window
    got = tgenome.CodeGenome({"c": codes}).get_encoding_from_coords(
        "c", start, end, strand)
    name = "codes_to_onehot_rc" if strand == "-" else "codes_to_onehot"
    assert tnative.calls == dict(dict.fromkeys(tnative.C_FUNCTIONS, 0),
                                 **{name: 1})
    assert_bit_equal(got, jgenome.CodeGenome({"c": codes})
                     .get_encoding_from_coords("c", start, end, strand))
    padded = tgenome.CodeGenome({"c": codes}).get_codes("c", start, end)
    assert_bit_equal(got, numpy_onehot(padded, strand))


@pytest.fixture
def no_library(monkeypatch):
    """The module as a fresh process finds it, before its first load."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_no_compiler", False)


def test_without_a_compiler_every_entry_point_returns_none(no_library,
                                                          monkeypatch,
                                                          tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    assert build.cxx_path() is None and not tnative.available()
    codes = np.array([0, 1, 2, 3, 4, 2], dtype=np.uint8)
    assert tnative.codes_to_onehot(codes) is None
    assert tnative.onehot_batch_gather(codes, np.zeros(1), np.zeros(1), 3) \
        is None
    assert tnative.fasta_to_codes(str(tmp_path / "absent.fa")) is None
    got = tgenome.CodeGenome({"c": codes}).get_encoding_from_coords(
        "c", -1, 4, "-")
    assert_bit_equal(got, numpy_onehot(np.array([4, 0, 1, 2, 3], np.uint8),
                                       "-"))
    assert sum(tnative.calls.values()) == 0


def _private_csrc(monkeypatch, tmp_path):
    """csrc/orca_native.cpp copied into a scratch source and build tree."""
    (tmp_path / "csrc").mkdir()
    src = tmp_path / "csrc" / "orca_native.cpp"
    shutil.copy(build.CSRC_DIR / "orca_native.cpp", src)
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path / "csrc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    return src


def test_a_failed_build_raises_with_the_compiler_log(no_library, monkeypatch,
                                                     tmp_path):
    src = _private_csrc(monkeypatch, tmp_path)
    src.write_text(src.read_text() + "\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="(?s)orca_native.cpp:.*error"):
        tnative.available()
    assert list(build.library_path("orca_native").parent.iterdir()) == []


def _sha256(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_racing_builds_give_one_library(monkeypatch, tmp_path):
    """Two threads build the same source at once (as test workers do); both
    succeed, one library is left and no temporary file, and the JAX
    package's committed library is untouched."""
    _private_csrc(monkeypatch, tmp_path)
    jax_lib = REPO / "native" / "liborca_native.so"
    before = _sha256(jax_lib)
    barrier = threading.Barrier(2)
    errors = []

    def run():
        barrier.wait()
        try:
            build.build(["orca_native"])
        except Exception as e:  # noqa: BLE001 -- read after the join
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert errors == []
    out = build.library_path("orca_native")
    assert out.parent.parent == tmp_path / "_build"
    assert [p.name for p in out.parent.iterdir()] == ["liborca_native.so"]
    lib = ctypes.CDLL(str(out))
    codes = np.array([3, 0, 4], dtype=np.uint8)
    got = np.empty((3, 4), dtype=np.float32)
    lib.codes_to_onehot(codes.ctypes.data_as(ctypes.c_void_p),
                        ctypes.c_longlong(3),
                        got.ctypes.data_as(ctypes.c_void_p))
    assert_bit_equal(got, numpy_onehot(codes, "+"))
    assert _sha256(jax_lib) == before


def test_a_changed_source_builds_into_a_new_directory(monkeypatch, tmp_path):
    src = _private_csrc(monkeypatch, tmp_path)
    build.build(["orca_native"])
    first = build.library_path("orca_native")
    src.write_text(src.read_text() + "\n// changed\n")
    second = build.library_path("orca_native")
    assert second.parent != first.parent and second.name == first.name
    assert not second.exists()
    build.build(["orca_native"])
    assert first.exists() and second.exists()


def test_the_port_builds_under_its_own_tree():
    out = build.library_path("orca_native")
    assert out.exists()  # loaded by the fixture
    assert out.parent.parent == REPO / "orca_tpu_torch" / "_build"
    assert build.source_path("orca_native") == (
        REPO / "orca_tpu_torch" / "csrc" / "orca_native.cpp")
