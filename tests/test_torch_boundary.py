"""The port's import boundary and device rule: every module of
pepr_tpu_torch, and chip_smoke.py as a module, import with jax and
pepr_tpu made unimportable; entry points asked for the card on a
machine without one raise instead of falling back to the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BOUNDARY = r"""
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None
sys.modules["pepr_tpu"] = None
sys.path.insert(0, ROOT)
import pepr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pepr_tpu_torch.__path__,
                                               "pepr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              ROOT + "/chip_smoke.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
assert callable(mod.main)
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "pepr_tpu" or m.startswith("pepr_tpu.")]
assert all(sys.modules[m] is None for m in bad), bad
print(len(names))
"""


def test_port_imports_without_jax_or_pepr_tpu():
    proc = subprocess.run(
        [sys.executable, "-c", f"ROOT = {ROOT!r}\n" + BOUNDARY],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    # 63 modules since the tools (models/treecompare, au_test,
    # neighbor_masher, io/alignio, setextract, utils/stats, tools/*), 65
    # since the mesh (parallel/mesh, entry), 67 since the native host
    # library (native, utils/libbuild)
    assert int(proc.stdout.strip().splitlines()[-1]) >= 67


def test_port_sources_never_name_jax_modules():
    hits = []
    for d, _, files in os.walk(os.path.join(ROOT, "pepr_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(d, f)).read()
                for line in src.splitlines():
                    s = line.strip()
                    if s.startswith(("import jax", "from jax",
                                     "import pepr_tpu ", "from pepr_tpu ",
                                     "from pepr_tpu.", "import pepr_tpu.")):
                        hits.append((f, s))
    assert not hits


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny():
    from pepr_tpu_torch.models.msa import Alignment
    from pepr_tpu_torch.tree import parse_newick
    from pepr_tpu_torch.utils.simulate import simulate_alignment
    rng = np.random.default_rng(0)
    tree = parse_newick("((A:0.1,B:0.2):0.1,(C:0.1,D:0.2):0.1,E:0.3);")
    codes, taxa = simulate_alignment(tree, 40, rng)
    return Alignment("g", taxa, codes), tree


def test_device_default_raises_without_card(no_cuda):
    from pepr_tpu_torch.device import resolve_device
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("entry", ["stage2", "ml_tree", "distances",
                                   "loglik", "replicates", "support",
                                   "stage1", "homology_search",
                                   "candidate_pairs", "sw_pairs", "mcl",
                                   "per_site_lls", "compare_builders",
                                   "tree_comparison_cli", "au_test_cli",
                                   "sharded_loglik", "sharded_replicates",
                                   "entry", "dryrun_multi"])
def test_entry_points_raise_not_fall_back(no_cuda, entry, tmp_path):
    from pepr_tpu_torch.io.alignio import write_fasta_alignment
    from pepr_tpu_torch.io.fasta import SequenceSet
    from pepr_tpu_torch.models import homology, support, treebuild
    from pepr_tpu_torch.models.concat import concatenate
    from pepr_tpu_torch.models.treecompare import per_site_log_likelihoods
    from pepr_tpu_torch import entry as tentry
    from pepr_tpu_torch.ops import kmer_filter, likelihood, mcl
    from pepr_tpu_torch.parallel import mesh, replicates
    from pepr_tpu_torch.pipeline import stage1, stage2
    from pepr_tpu_torch.tools import au_test, tree_comparison
    from pepr_tpu_torch.tools.treebuilder_compare import compare_builders
    from pepr_tpu_torch.tree import to_newick
    aln, tree = _tiny()
    aln_file = tmp_path / "aln.afa"
    aln_file.write_text(write_fasta_alignment(aln))
    tree_file = tmp_path / "t.nwk"
    tree_file.write_text(to_newick(tree) + "\n")
    trees_file = tmp_path / "trees.nwk"
    trees_file.write_text(2 * (to_newick(tree) + "\n"))
    genome = SequenceSet("g", [f"p{i} [G s]" for i in range(len(aln.mat))],
                         list(aln.mat))
    prof = kmer_filter.kmer_profiles(genome.seqs)
    arr = likelihood.tree_to_arrays(tree, aln.taxa)
    model = likelihood.WagModel.create()
    calls = {
        "stage2": lambda: stage2.run_stage2_aligned([aln]),
        "ml_tree": lambda: treebuild.ml_tree(aln.mat, aln.taxa),
        "distances": lambda: treebuild.protein_distances(aln.mat),
        "loglik": lambda: likelihood.loglik(aln.mat, arr.children, arr.blen,
                                            model),
        "replicates": lambda: replicates.replicate_blopt(
            aln.mat, np.ones((1, 40), np.float32), arr.children[None],
            arr.blen[None], model),
        "support": lambda: support.support_trees(concatenate([aln]), 2, 0),
        "stage1": lambda: stage1.run_stage1(
            [genome], [], stage1.Stage1Config(use_hmm=False)),
        "homology_search": lambda: homology.search_all_vs_all([genome]),
        "candidate_pairs": lambda: kmer_filter.candidate_pairs(
            prof, prof, np.array([0, len(prof)])),
        "sw_pairs": lambda: homology._bucketed_sw(
            genome.seqs, np.array([0]), np.array([1])),
        "mcl": lambda: mcl.mcl_cluster(3, np.array([0]), np.array([1]),
                                       np.array([1.0])),
        "per_site_lls": lambda: per_site_log_likelihoods(
            [tree, tree], aln.mat, aln.taxa),
        "compare_builders": lambda: compare_builders(aln.mat, aln.taxa,
                                                     ["nj"]),
        "tree_comparison_cli": lambda: tree_comparison.main(
            [str(tree_file), str(tree_file), "-align", str(aln_file),
             "-sitelh", str(tmp_path / "t.sitelh")]),
        "au_test_cli": lambda: au_test.main(
            ["-alignment", str(aln_file), "-trees", str(trees_file)]),
        "sharded_loglik": lambda: mesh.sharded_loglik(
            mesh.default_mesh(), aln.mat, np.ones(40, np.float32),
            arr.children, arr.blen, model),
        "sharded_replicates": lambda: mesh.sharded_replicate_blopt(
            mesh.default_mesh(), aln.mat, np.ones((1, 40), np.float32),
            arr.children[None], arr.blen[None], model),
        "entry": lambda: tentry.entry(),
        "dryrun_multi": lambda: tentry.dryrun_multi(2),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def test_chip_smoke_refuses_without_card(no_cuda, capsys):
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    assert chip_smoke.main([]) == 2
    out = capsys.readouterr().out
    assert '"ok"' not in out
