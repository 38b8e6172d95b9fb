"""The port's alignment I/O, set extraction and the six tool CLIs
(pepr_tpu_torch.io.alignio, io.setextract, tools.*) against the JAX
package on the same inputs and files, on the CPU (`-device cpu`).

Tolerances: parsed alignments, written texts, set files and the stdout
of every CLI identical, except seconds (dropped) and log-likelihoods,
`alpha` and `.sitelh` values (rel 1e-5 plus 1e-5 absolute: float32 sums
in another order).  F7: the JAX AU CLI's `-alignment` mode passes the
file's path where its parser wants the text, so it raises; the port's
reads the file and reports what `-sitelh` reports."""

import os
import re

import numpy as np
import pytest
import torch

from pepr_tpu.io import alignio as jaio
from pepr_tpu.io import setextract as jse
from pepr_tpu.io.fasta import read_fasta as jread_fasta
from pepr_tpu.models.msa import Alignment as JAlignment
from pepr_tpu.tools import au_test as jau_cli
from pepr_tpu.tools import neighbor_masher as jnm_cli
from pepr_tpu.tools import set_extractor as jse_cli
from pepr_tpu.tools import tree_comparison as jtc_cli
from pepr_tpu.tools import tree_support as jts_cli
from pepr_tpu.tools import treebuilder_compare as jtb_cli
from pepr_tpu.tree import parse_newick as jparse
from pepr_tpu.utils.simulate import simulate_alignment as jsimulate

from pepr_tpu_torch.io import alignio as taio
from pepr_tpu_torch.io import setextract as tse
from pepr_tpu_torch.io.fasta import read_fasta, write_fasta
from pepr_tpu_torch.models.msa import Alignment
from pepr_tpu_torch.tools import au_test as tau_cli
from pepr_tpu_torch.tools import neighbor_masher as tnm_cli
from pepr_tpu_torch.tools import set_extractor as tse_cli
from pepr_tpu_torch.tools import tree_comparison as ttc_cli
from pepr_tpu_torch.tools import tree_support as tts_cli
from pepr_tpu_torch.tools import treebuilder_compare as ttb_cli
from pepr_tpu_torch.tree import to_newick
from pepr_tpu_torch.utils.simulate import random_tree, simulate_genomes

torch.set_num_threads(2)
LL_RTOL = 1e-5
LL_ATOL = 1e-5
AU_REPS = "200"
TREE8 = ("(((t0:0.1,t1:0.2):0.1,(t2:0.15,t3:0.1):0.2):0.05,"
         "(t4:0.1,t5:0.3):0.1,(t6:0.2,t7:0.1):0.15);")


def _write(path, text):
    with open(path, "w") as fh:
        fh.write(text)
    return str(path)


def _read(path):
    with open(path) as fh:
        return fh.read()


@pytest.fixture(scope="module")
def aln():
    """8 taxa x 240 columns with gaps, X and B."""
    rng = np.random.default_rng(21)
    codes, taxa = jsimulate(jparse(TREE8), 240, rng, alpha=0.8)
    codes[rng.random(codes.shape) < 0.05] = 23
    codes[0, 3] = 22
    codes[4, 10:14] = 20
    return codes, taxa


def _same_alignment(a, b):
    assert list(a.taxa) == list(b.taxa)
    assert a.mat.dtype == b.mat.dtype and np.array_equal(a.mat, b.mat)


WRITERS = ["write_fasta_alignment", "write_phylip", "write_clustal",
           "write_nexus"]


@pytest.mark.parametrize("writer", WRITERS)
def test_writers_and_parsers_identical(aln, writer):
    codes, taxa = aln
    text = getattr(taio, writer)(Alignment("x", list(taxa), codes))
    assert text == getattr(jaio, writer)(JAlignment("x", list(taxa), codes))
    parser = {"write_fasta_alignment": "parse_fasta_alignment",
              "write_phylip": "parse_phylip",
              "write_clustal": "parse_clustal",
              "write_nexus": "parse_nexus"}[writer]
    got = getattr(taio, parser)(text, "y")
    _same_alignment(got, getattr(jaio, parser)(text, "y"))
    _same_alignment(taio.parse_alignment(text), jaio.parse_alignment(text))
    # every format gives back the written codes
    _same_alignment(got, Alignment("x", list(taxa), codes))


HAND_WRITTEN = [
    # interleaved phylip
    " 3 12\nalpha  ARND CQ\nbeta   ARNE CQ\ngamma  A-ND CQ\n\n"
    "EGHILK\nEGHIL-\nEGHXLK\n",
    # clustal with a conservation line and a MUSCLE header
    "MUSCLE (3.8) multiple sequence alignment\n\n"
    "s1      ARNDCQ\ns2      ARN-CQ\n        *** **\n\n"
    "s1      EGH\ns2      EGX\n",
    # nexus with comments and quoted names
    "#NEXUS\nbegin data;\n  dimensions ntax=2 nchar=8;\n  matrix\n"
    "  [a comment]\n  'one' ARND\n  'two' AR-D\n  'one' CQEG\n"
    "  'two' CQ?G\n  ;\nend;\n",
    # fasta with wrapped rows and descriptions
    ">a desc\nARND\nCQ\n>b\nAR-D\nCX\n",
]


@pytest.mark.parametrize("text", HAND_WRITTEN)
def test_hand_written_inputs_parse_identically(text):
    _same_alignment(taio.parse_alignment(text, "h"),
                    jaio.parse_alignment(text, "h"))


def test_nexus_without_matrix_raises_like_jax():
    for mod in (taio, jaio):
        with pytest.raises(ValueError, match="no matrix"):
            mod.parse_nexus("#NEXUS\nbegin data;\nend;\n")


@pytest.mark.parametrize("dtype", [np.int8, np.int64])
@pytest.mark.parametrize("pad_char", ["", "-", "ab"])
def test_decode_identical(dtype, pad_char):
    """The port's table-lookup decode against the JAX package's loop:
    every code, PAD, codes outside the table (negative, 25 and above)."""
    from pepr_tpu.alphabet import decode as jdecode
    from pepr_tpu_torch.alphabet import decode
    codes = np.random.default_rng(2).integers(-4, 40, 2000).astype(dtype)
    assert decode(codes, pad_char) == jdecode(codes, pad_char)
    assert decode(codes[:0], pad_char) == "" == jdecode(codes[:0], pad_char)


@pytest.fixture(scope="module")
def genome_files(tmp_path_factory):
    """3 ingroup and 2 pool genomes of ~30 proteins written as FASTA, and
    a set file of 8 sets (one id missing from every genome)."""
    d = tmp_path_factory.mktemp("genomes")
    ingroup, pool, _ = simulate_genomes(
        np.random.default_rng(5), n_ingroup=3, n_pool=2, n_families=30,
        n_random=3, median_len=80.0, max_len=160, n_long=0)
    paths = []
    for g in ingroup + pool:
        p = str(d / f"{g.name}.faa")
        write_fasta(p, g)
        paths.append(p)
    rng = np.random.default_rng(6)
    ids = [i for g in ingroup + pool for i in g.ids]
    lines = ["\t".join(rng.choice(ids, size=int(rng.integers(2, 6)),
                                  replace=False)) for _ in range(7)]
    lines.append("\t".join([ids[0], "no_such_protein", ids[-1]]))
    set_file = _write(d / "sets.txt", "\n".join(lines) + "\n\n")
    return paths[:3], paths[3:], set_file


def _dir_files(d):
    return {f: _read(os.path.join(d, f)) for f in sorted(os.listdir(d))}


def test_set_extraction_identical(genome_files, tmp_path):
    ingroup, pool, set_file = genome_files
    ids = tse.parse_set_file(set_file)
    assert ids == jse.parse_set_file(set_file) and len(ids) == 8
    got = tse.extract_sets(ids, [read_fasta(p) for p in ingroup + pool])
    want = jse.extract_sets(ids, [jread_fasta(p) for p in ingroup + pool])
    assert [s.titles for s in got] == [s.titles for s in want]
    assert len(got[-1]) == 2
    tse.write_set_files(got, str(tmp_path / "t"))
    jse.write_set_files(want, str(tmp_path / "j"))
    files = _dir_files(tmp_path / "t")
    assert len(files) == 8 and files == _dir_files(tmp_path / "j")


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("pair", [
    (ttc_cli, jtc_cli), (tau_cli, jau_cli), (tts_cli, jts_cli),
    (tse_cli, jse_cli), (tnm_cli, jnm_cli), (ttb_cli, jtb_cli)],
    ids=["tree_comparison", "au_test", "tree_support", "set_extractor",
         "neighbor_masher", "treebuilder_compare"])
def test_cli_usage_returns_2(pair, capsys):
    """No arguments: the usage (the module's docstring, on stdout or, for
    the AU CLI, stderr) and exit code 2, as the JAX CLI gives."""
    port, jax_cli = pair
    assert jax_cli.main([]) == 2
    capsys.readouterr()
    assert port.main([]) == 2
    shown = capsys.readouterr()
    assert port.__doc__.strip() in shown.out + shown.err
    assert "python -m pepr_tpu_torch.tools." in port.__doc__


MAIN_USAGE = r"""
import runpy, sys
codes = []
for name in NAMES:
    sys.argv = [name]
    try:
        runpy.run_module("pepr_tpu_torch.tools." + name, run_name="__main__")
    except SystemExit as e:
        codes.append(e.code)
print(codes)
"""


def test_python_m_without_arguments_exits_2():
    import subprocess
    import sys
    names = ["tree_comparison", "au_test", "tree_support", "set_extractor",
             "neighbor_masher", "treebuilder_compare"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", f"NAMES = {names!r}\n" + MAIN_USAGE],
        capture_output=True, text=True, timeout=300, cwd=root)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == str([2] * 6)


@pytest.fixture(scope="module")
def scoring_files(aln, tmp_path_factory):
    """The fixture alignment as FASTA, two trees over its taxa (the
    generating tree and a random rooted one), the two trees in one
    file, and the JAX tree_comparison CLI's .sitelh of them."""
    d = tmp_path_factory.mktemp("scoring")
    codes, taxa = aln
    f = {"aln": _write(d / "aln.afa", jaio.write_fasta_alignment(
            JAlignment("a", list(taxa), codes))),
         "t1": _write(d / "t1.nwk", TREE8 + "\n"),
         "t2": _write(d / "t2.nwk", to_newick(random_tree(
             list(taxa), np.random.default_rng(8))) + "\n")}
    f["trees"] = _write(d / "trees.nwk", _read(f["t1"]) + _read(f["t2"]))
    f["jax_sitelh"] = str(d / "jax.sitelh")
    f["jax_out"] = _capture(jtc_cli.main, [f["t1"], f["t2"], "-align",
                                           f["aln"], "-sitelh",
                                           f["jax_sitelh"]])
    return f


def _capture(main, argv):
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _split_numbers(out: str, keys) -> tuple[list[str], list[float]]:
    """The lines of `out` with the values after `key<TAB>` or `key=` for
    each of `keys` taken out as floats."""
    lines, nums = [], []
    for line in out.splitlines():
        for k in keys:
            m = re.search(rf"({re.escape(k)}[\t=])(-?[0-9.]+)", line)
            if m:
                nums.append(float(m.group(2)))
                line = line[:m.start(2)] + "#" + line[m.end(2):]
        lines.append(line)
    return lines, nums


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and got.size
    assert np.all(np.abs(got - want) <= LL_RTOL * np.abs(want) + LL_ATOL)


def test_tree_comparison_cli_matches_jax(scoring_files, tmp_path, capsys):
    f = scoring_files
    out = str(tmp_path / "port.sitelh")
    rc, got = _run(ttc_cli.main, [f["t1"], f["t2"], "-align", f["aln"],
                                  "-sitelh", out, "-device", "cpu"], capsys)
    assert rc == 0
    want = f["jax_out"].replace(f["jax_sitelh"], out)
    keys = ("total_ll_tree1", "total_ll_tree2")
    g_lines, g_nums = _split_numbers(got, keys)
    w_lines, w_nums = _split_numbers(want, keys)
    assert g_lines == w_lines and len(g_nums) == 2
    _close(g_nums, w_nums)
    g, w = tau_cli.read_sitelh(out), jau_cli.read_sitelh(f["jax_sitelh"])
    assert g.shape == w.shape == (2, 240)
    _close(g, w)
    assert _read(out).split("\t")[0] == _read(f["jax_sitelh"]).split("\t")[0]
    # without an alignment: the distances alone
    rc, got = _run(ttc_cli.main, [f["t1"], f["t2"]], capsys)
    assert rc == 0 and got == _capture(jtc_cli.main, [f["t1"], f["t2"]])


def test_au_test_cli_sitelh_identical(scoring_files, capsys):
    f = scoring_files
    argv = ["-sitelh", f["jax_sitelh"], "-reps", AU_REPS, "-seed", "3"]
    rc, got = _run(tau_cli.main, argv, capsys)
    assert rc == 0 and got == _capture(jau_cli.main, argv)
    assert got.startswith("# rank") and len(got.splitlines()) == 3


def test_f7_jax_alignment_mode_raises_port_reads_the_file(scoring_files,
                                                          capsys):
    f = scoring_files
    with pytest.raises(ValueError, match="invalid literal"):
        jau_cli.main(["-alignment", f["aln"], "-trees", f["trees"]])
    rc, got = _run(tau_cli.main, ["-alignment", f["aln"], "-trees",
                                  f["trees"], "-reps", AU_REPS,
                                  "-device", "cpu"], capsys)
    assert rc == 0
    assert got == _capture(jau_cli.main, ["-sitelh", f["jax_sitelh"],
                                          "-reps", AU_REPS])


def test_tree_support_cli_identical(tmp_path, capsys):
    rng = np.random.default_rng(9)
    taxa = [f"t{i}" for i in range(8)]
    main = _write(tmp_path / "main.nwk", TREE8 + "\n")
    sup = _write(tmp_path / "sup.nwk", "\n".join(
        [TREE8] * 3 + [to_newick(random_tree(taxa, rng))
                       for _ in range(5)]) + "\n")
    rc, got = _run(tts_cli.main, [main, sup], capsys)
    assert rc == 0 and got == _capture(jts_cli.main, [main, sup])
    assert got.count(")") == TREE8.count(")")


def test_set_extractor_cli_identical(genome_files, tmp_path, capsys):
    ingroup, pool, set_file = genome_files
    outs = {}
    for name, main in (("t", tse_cli.main), ("j", jse_cli.main)):
        d = str(tmp_path / name)
        outs[name] = _capture(main, ["-set_file", set_file, "-genome_file",
                                     *ingroup, *pool, "-out_dir", d])
        outs[name] = outs[name].replace(d, "OUT")
    assert outs["t"] == outs["j"] == "wrote 8 set files to OUT\n"
    assert _dir_files(tmp_path / "t") == _dir_files(tmp_path / "j")


@pytest.mark.parametrize("extra", [[], ["-tree"], ["-outgroup_count", "1"]])
def test_neighbor_masher_cli_identical(genome_files, extra):
    ingroup, pool, _ = genome_files
    for argv in (["-genome_file", *ingroup, *extra],
                 ["-genome_file", *ingroup, "-outgroup", *pool, *extra]):
        got = _capture(tnm_cli.main, argv)
        assert got == _capture(jnm_cli.main, argv)
    assert got.startswith("selected_outgroups\t")


def test_treebuilder_compare_cli_matches_jax(scoring_files, capsys):
    f = scoring_files
    rc, got = _run(ttb_cli.main, [f["aln"], "-methods", "fast_ml,nj",
                                  "-device", "cpu"], capsys)
    assert rc == 0
    want = _capture(jtb_cli.main, [f["aln"], "-methods", "fast_ml,nj"])
    drop = lambda s: re.sub(r"seconds=[0-9.]+", "seconds=#", s)  # noqa
    g_lines, g_nums = _split_numbers(drop(got), ("alpha", "ll"))
    w_lines, w_nums = _split_numbers(drop(want), ("alpha", "ll"))
    assert g_lines == w_lines and len(g_nums) == 3
    _close(g_nums, w_nums)
    assert "rf\tfast_ml-nj\t" in got
