"""The port's native host library (pepr_tpu_torch/native) against the
JAX package's (pepr_tpu/native): the FASTA scanner, the k-mer counter
and union-find bit for bit; the functions wired through it
(`read_fasta`, `kmer_profiles`, `connected_components`) equal to the
JAX package's; its build (from its own source, into `_build/`, a
failed compiler raising, no fallback)."""

import os
import sys

import numpy as np
import pytest

import pepr_tpu.native as jnative
from pepr_tpu.io.fasta import read_fasta as j_read_fasta
from pepr_tpu.ops.kmer_filter import kmer_profiles as j_kmer_profiles
from pepr_tpu.ops.mcl import connected_components as j_components

from pepr_tpu_torch import native
from pepr_tpu_torch.io.fasta import read_fasta, read_fasta_reference
from pepr_tpu_torch.ops.kmer_filter import (kmer_profiles,
                                            kmer_profiles_reference)
from pepr_tpu_torch.ops.mcl import (connected_components,
                                    connected_components_reference)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX package's native library must be the one it uses here (g++
    and its tracked library are present), or the comparison is with its
    Python fallback."""
    assert jnative.get_lib() is not None


def _random_seqs(rng, n, lo, hi, top=25):
    return [rng.integers(0, top, size=int(rng.integers(lo, hi)))
            .astype(np.int8) for _ in range(n)]


# -- k-mer profiles ---------------------------------------------------------

@pytest.mark.parametrize("k,dim,clip", [(4, 1024, 3), (3, 256, 1),
                                        (5, 512, 7), (2, 64, 3),
                                        (4, 256, 3)])
def test_kmer_profiles_bit_for_bit(k, dim, clip):
    """Codes 0-24 (>= 20 are ambiguous and break windows), lengths 0-300
    (many shorter than k), and an empty set."""
    rng = np.random.default_rng(k * 1000 + dim + clip)
    seqs = _random_seqs(rng, 300, 0, 300)
    seqs += [np.zeros(0, np.int8), np.arange(k - 1, dtype=np.int8),
             np.full(50, 22, np.int8)]
    got = native.native_kmer_profiles(seqs, k, dim, clip)
    want = jnative.native_kmer_profiles(seqs, k, dim, clip)
    assert got.dtype == np.float32 and got.shape == (len(seqs), dim)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert np.array_equal(kmer_profiles(seqs, k, dim, clip), got)
    assert native.native_kmer_profiles([], k, dim, clip).shape == (0, dim)


def test_f8_numpy_reference_is_an_ulp_off_wired_path_equals_jax():
    """F8 (ROADMAP Queue 3): the numpy reference takes the norm in
    float32 and divides, the native loop in float64 and multiplies.  On
    3,000 random sequences of 50-600 codes (seed 0) the reference
    differs from the native rows in some rows, by at most one float32
    ulp; the wired `kmer_profiles` equals the JAX package's bit for
    bit."""
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, 20, size=int(rng.integers(50, 601)))
            .astype(np.int8) for _ in range(3000)]
    got = kmer_profiles(seqs, 4, 1024, 3)
    ref = kmer_profiles_reference(seqs, 4, 1024, 3)
    want = j_kmer_profiles(seqs, 4, 1024, 3)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    rows = (got != ref).any(axis=1)
    assert 0 < rows.sum() < len(seqs)
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(ref)))
    assert (np.abs(got - ref) <= ulp).all()
    # the counts are the same: the zero pattern agrees exactly
    assert np.array_equal(got == 0, ref == 0)


# -- union-find -------------------------------------------------------------

@pytest.mark.parametrize("n,m,seed", [(1, 0, 0), (50, 0, 1), (200, 150, 2),
                                      (2000, 1500, 3), (5000, 20000, 4)])
def test_connected_components_bit_for_bit(n, m, seed):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, size=m)
    ej = rng.integers(0, n, size=m)
    got = native.native_connected_components(n, ei, ej)
    assert got.dtype == np.int64
    assert np.array_equal(got, jnative.native_connected_components(n, ei,
                                                                   ej))
    assert np.array_equal(connected_components(n, ei, ej), got)
    assert np.array_equal(j_components(n, ei, ej), got)
    # the plain version gives the same roots
    assert np.array_equal(connected_components_reference(n, ei, ej), got)


# -- FASTA ------------------------------------------------------------------

FASTA_CASES = {
    "plain": b">seq1 desc one [Tax A]\nACDEF\nGHIK\n>seq2 [Tax B]\n"
             b"MNPQRSTU\n\n>seq3 [Tax C]\nW\n",
    "blank_in_sequence": b">p1 [T]\nACDE FG*\nKL\tM\n>p2 [T]\nAAA\n",
    "indented_header": b">p1 [T]\nACDEFG\n  >p2 [T]\nMMM\n>p3 [T]\nWW\n",
    "crlf": b">a one [T]\r\nACDE\r\nFGH\r\n>b two [T]\r\nKLM\r\n",
    "gt_in_title": b">p1 3'->5' exoribonuclease [T]\nACD\n>p2 a>b [T]\nEF\n",
    "empty_records": b">e1 [T]\n>e2 [T]\n\n>p3 [T]\nAC\n>e4 [T]\n",
    "before_first_header": b"ACDE\n>p1 [T]\nKL\n",
    "no_trailing_newline": b">p1 [T]\nACDE\n>p2  padded title   [T]  \nKLM",
    "lowercase_and_gaps": b">p1 [T]\nacd-e.f?xBZ\n>p2 [T]\nUOJ*\n",
    "empty_file": b"",
}


def _write(tmp_path, name, data):
    path = tmp_path / f"{name}.faa"
    path.write_bytes(data)
    return str(path)


@pytest.mark.parametrize("case", sorted(FASTA_CASES))
def test_read_fasta_bit_for_bit(case, tmp_path):
    """The port's scanner, and `read_fasta` through it, against the JAX
    package's scanner and its `read_fasta`: titles, codes, the count of
    records and the set's name."""
    path = _write(tmp_path, case, FASTA_CASES[case])
    titles, seqs = native.native_read_fasta(path)
    want = jnative.native_read_fasta(path)
    assert titles == want[0]
    assert len(seqs) == len(want[1])
    for a, b in zip(seqs, want[1]):
        assert a.dtype == np.int8 and np.array_equal(a, b)
    got, j = read_fasta(path), j_read_fasta(path)
    assert got.name == j.name == case and got.titles == j.titles
    assert len(got.seqs) == len(j.seqs)
    for a, b in zip(got.seqs, j.seqs):
        assert np.array_equal(a, np.asarray(b))
    assert got.taxa == j.taxa


def test_f9_blanks_and_indented_headers_parse_as_jax(tmp_path):
    """F9 (ROADMAP Queue 3): with a blank inside a sequence line and a
    line '  >p2', the line reader (the port's earlier path, and the JAX
    package's own fallback) keeps the blank as code 22 and opens a
    record at '  >p2'; the scanner, in both packages, drops the blank and
    reads '  >p2' as residues of the record before it.  `read_fasta`
    takes the scanner."""
    path = _write(tmp_path, "f9", b">p1 [T]\nACDE FG*\n  >p2 [T]\nMMM\n")
    got = read_fasta(path)
    line = read_fasta_reference(path)
    assert got.titles == j_read_fasta(path).titles == ["p1 [T]"]
    assert line.titles == ["p1 [T]", "p2 [T]"]
    # the line reader: 'ACDE FG*' is 8 codes, the blank one of them
    assert len(line.seqs[0]) == 8 and line.seqs[0][4] == 22
    # the scanner: the 7 residues, then '>p2[T]' (6 codes) and 'MMM'
    assert len(got.seqs[0]) == 7 + 6 + 3
    assert np.array_equal(got.seqs[0][:7], np.delete(line.seqs[0], 4))
    assert np.array_equal(got.seqs[0][-3:], line.seqs[1])


def test_f10_high_bytes_and_a_bom_stay_inside_the_buffers(tmp_path):
    """F10 (ROADMAP Queue 3): the JAX package's fasta_stats reads bytes
    as signed char and so does not count a byte of 0x80 or above as a
    residue, while fasta_parse writes it: its codes buffer overflows
    (not run here).  The port's scanner counts and writes each such byte
    as one X code.  A UTF-8 byte-order mark puts the first '>' off the
    start of its line, so that record's bytes are residues before the
    first record, as the line reader also drops it; 200,000 high bytes in
    one record would have overrun the buffer by as many."""
    from pepr_tpu_torch.alphabet import X, encode
    path = _write(tmp_path, "high", b">p1 caf\xc3\xa9 [T]\nAC\xe9DE\xff\n"
                                    b"\x80G\n>p2 [T]\nKL\n")
    titles, seqs = native.native_read_fasta(path)
    assert titles == ["p1 caf\u00e9 [T]", "p2 [T]"]
    assert np.array_equal(seqs[0], np.array(
        [*encode("AC"), X, *encode("DE"), X, X, *encode("G")], np.int8))
    assert np.array_equal(seqs[1], encode("KL"))
    bom = b"\xef\xbb\xbf>p1 [T]\nACDE\n>p2 [T]\nKLM\n>p3 [T]\nW\n"
    path = _write(tmp_path, "bom", bom)
    titles, seqs = native.native_read_fasta(path)
    line = read_fasta_reference(path)
    assert titles == line.titles == ["p2 [T]", "p3 [T]"]
    for a, b in zip(seqs, line.seqs):
        assert np.array_equal(a, b)
    n = 200_000
    path = _write(tmp_path, "many", b">p1 [T]\n" + b"\xfe" * n
                  + b"\nAC\n>p2 [T]\nW\n")
    titles, seqs = native.native_read_fasta(path)
    assert titles == ["p1 [T]", "p2 [T]"] and len(seqs[0]) == n + 2
    assert (seqs[0][:n] == X).all() and np.array_equal(seqs[1], encode("W"))


def test_nucleotide_files_read_line_by_line_as_jax(tmp_path):
    path = _write(tmp_path, "nt", b">c1 [T]\nACGTU\nnnRY\n>c2 [T]\nAC-GT\n")
    got = read_fasta(path, alphabet="nt")
    want = j_read_fasta(path, alphabet="nt")
    ref = read_fasta_reference(path, alphabet="nt")
    assert got.titles == want.titles == ref.titles
    for a, b, c in zip(got.seqs, want.seqs, ref.seqs):
        assert np.array_equal(a, np.asarray(b)) and np.array_equal(a, c)


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        read_fasta(str(tmp_path / "absent.faa"))


def test_read_fasta_real_sized_file(tmp_path):
    """A genome-sized file: the rows of the first 120 exported
    Aquificales families (realdata/, 1,440 proteins) written as FASTA, 60
    residues a line, gaps removed, under their titles."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    from pepr_tpu_torch.alphabet import decode
    alns, _ = chip_smoke.load_realdata("aqu")
    lines = []
    for a in alns[:120]:
        for title, row in zip(a.titles, a.mat):
            s = decode(row).replace("-", "")
            lines.append(f">{title}")
            lines += [s[j:j + 60] for j in range(0, len(s), 60)]
    path = _write(tmp_path, "genome", ("\n".join(lines) + "\n").encode())
    got, want = read_fasta(path), j_read_fasta(path)
    assert len(got.seqs) == 1440 and got.titles == want.titles
    assert sum(len(s) for s in got.seqs) > 300_000
    for a, b in zip(got.seqs, want.seqs):
        assert np.array_equal(a, np.asarray(b))
    assert got.taxa == want.taxa


# -- the build --------------------------------------------------------------

def test_built_from_its_own_source_into_build_dir():
    native.library()
    assert native.SOURCE == os.path.join(ROOT, "pepr_tpu_torch", "native",
                                         "fastio.cpp")
    assert native.lib_path().startswith(native.BUILD_DIR)
    assert native.BUILD_DIR == os.path.join(ROOT, "pepr_tpu_torch", "_build")
    with open(native.lib_path() + ".sha256") as fh:
        from pepr_tpu_torch.utils.libbuild import file_digest
        assert fh.read() == file_digest(native.SOURCE) + "\n"
    # the JAX loader's flags, without -march=native
    cmd = native.gxx_command("g++", native.SOURCE, "/x/lib.so")
    assert cmd == ["g++", "-O3", "-shared", "-fPIC", native.SOURCE, "-o",
                   "/x/lib.so"]
    # the source's loops are the JAX package's, but for one line:
    # fasta_stats reads each byte unsigned, as fasta_parse does (F10)
    with open(native.SOURCE) as a, open(os.path.join(
            ROOT, "pepr_tpu", "native", "fastio.cpp")) as b:
        mine, theirs = a.read(), b.read()
    mine = mine[mine.index("#include"):].splitlines()
    theirs = theirs[theirs.index("#include"):].splitlines()
    i = theirs.index("            char c = buf[i];")
    assert mine[:i] == theirs[:i] and mine[i + 3:] == theirs[i + 1:]
    assert mine[i + 2] == "            unsigned char c = (unsigned char)buf[i];"
    assert mine[i:i + 2] == [
        "            // unsigned, as in fasta_parse: a byte of 0x80 or above is a",
        "            // residue in both passes, so the count sizes the codes buffer"]


def test_rebuilds_when_the_source_changes(tmp_path, monkeypatch):
    src = tmp_path / "fastio.cpp"
    src.write_text(open(native.SOURCE).read())
    monkeypatch.setattr(native, "SOURCE", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    assert sorted(native.build()) == ["fastio"]
    assert sorted(os.listdir(tmp_path / "build")) == [
        "libpepr_fastio.so", "libpepr_fastio.so.sha256"]
    assert native.build() == {}
    src.write_text(src.read_text() + "\n// changed\n")
    assert sorted(native.build()) == ["fastio"]
    seqs = [np.arange(20, dtype=np.int8)]
    assert np.array_equal(native.native_kmer_profiles(seqs, 4, 64, 3),
                          jnative.native_kmer_profiles(seqs, 4, 64, 3))


@pytest.mark.parametrize("compiler", ["/bin/false", "/nonexistent/g++"])
def test_failing_compiler_raises_nothing_falls_back(compiler, tmp_path,
                                                    monkeypatch):
    """A compiler that fails, or is not there, raises RuntimeError with
    its output from every entry that needs the library; no environment
    variable switches the library off."""
    monkeypatch.setattr(native, "COMPILER", compiler)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("PEPR_NO_NATIVE", "1")
    path = _write(tmp_path, "x", FASTA_CASES["plain"])
    seqs = [np.arange(20, dtype=np.int8)]
    for call in (lambda: native.library(),
                 lambda: kmer_profiles(seqs),
                 lambda: connected_components(3, [0], [1]),
                 lambda: read_fasta(path)):
        with pytest.raises(RuntimeError, match="failed to build"):
            call()
    assert not os.path.exists(native.lib_path())
    assert [f for f in os.listdir(tmp_path / "build")] == []
