"""The port's tree comparison, AU test, MinHash distances and statistics
(pepr_tpu_torch.models.treecompare, au_test, neighbor_masher and
utils.stats) against the JAX package on the same inputs, on the CPU.

Tolerances: per-site log-likelihoods rel 1e-5 plus 1e-5 absolute (float32
sums in another order; the port unroots a bifurcating root, merging its
two edges); branch-score distances 1e-12; everything else (statistics,
the AU test and its report, sketches, distances, the NJ Newick, the
chosen outgroups, the .sitelh text of the same values) identical."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pepr_tpu.io.fasta import SequenceSet as JSequenceSet
from pepr_tpu.models import au_test as jau
from pepr_tpu.models import neighbor_masher as jnm
from pepr_tpu.models import treecompare as jtc
from pepr_tpu.models.treebuild import nj_start_tree as jnj_start
from pepr_tpu.ops import likelihood as jlik
from pepr_tpu.ops.pallas_pruning import (A_PAD, block_diag_pmats,
                                         chosen_tile, pruning_site_ll_pallas)
from pepr_tpu.tree import parse_newick as jparse
from pepr_tpu.tree import to_newick as jto_newick
from pepr_tpu.tree import unroot as junroot
from pepr_tpu.utils import stats as jstats
from pepr_tpu.utils.simulate import simulate_alignment as jsimulate

from pepr_tpu_torch.alphabet import PAD
from pepr_tpu_torch.models import au_test as tau
from pepr_tpu_torch.models import neighbor_masher as tnm
from pepr_tpu_torch.models import treecompare as ttc
from pepr_tpu_torch.ops import likelihood as tlik
from pepr_tpu_torch.tree import parse_newick, to_newick
from pepr_tpu_torch.utils import stats as tstats
from pepr_tpu_torch.utils.simulate import random_tree, simulate_genomes

torch.set_num_threads(2)
LL_RTOL = 1e-5
LL_ATOL = 1e-5
BSD_TOL = 1e-12
N_TAXA = 8
N_SITES = 300


def _close(got, want, rtol=LL_RTOL, atol=LL_ATOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= rtol * np.abs(want) + atol), \
        float(np.abs(got - want).max())


def _jtree(t):
    return jparse(to_newick(t))


@pytest.fixture(scope="module")
def scored():
    """8 taxa x 300 columns (gaps, an X, an all-gap column) and four
    trees: the generating tree and a random one (both rooted binary),
    the NJ tree (a 3-child root) and the generating tree unrooted."""
    rng = np.random.default_rng(11)
    taxa = [f"t{i}" for i in range(N_TAXA)]
    truth = _jtree(random_tree(taxa, rng))
    codes, taxa = jsimulate(truth, N_SITES, rng, alpha=0.7)
    codes[rng.random(codes.shape) < 0.06] = 23
    codes[1, 9] = 22
    codes[:, 17] = 23
    nj = jnj_start(codes, taxa)
    trees = [truth, _jtree(random_tree(taxa, rng)), nj, junroot(truth)]
    jm = jlik.WagModel.create(alpha=0.7)
    tm = tlik.from_jax_arrays(jm.eig, jm.u, jm.u_inv, jm.pi, jm.rates)
    return codes, taxa, trees, jm, tm


def test_per_site_log_likelihoods_match_jax_scan(scored):
    codes, taxa, trees, jm, tm = scored
    want = jtc.per_site_log_likelihoods(trees, codes, taxa, jm)
    got = ttc.per_site_log_likelihoods(
        [parse_newick(jto_newick(t)) for t in trees], codes, taxa, tm,
        device="cpu")
    assert got.dtype == np.float32 and want.dtype == np.float32
    assert got.shape == (len(trees), N_SITES)
    _close(got, want)
    # the same values print as the same .sitelh text
    assert ttc.sitelh_text(got).splitlines()[0] == \
        jtc.sitelh_text(want).splitlines()[0]


def test_one_tree_matches_pallas_interpret(scored):
    """The NJ tree (its root already has 3 children, so both packages
    score the same arrays) against the Pallas forward kernel."""
    codes, taxa, trees, jm, tm = scored
    nj = trees[2]
    jarr = jlik.tree_to_arrays(nj, taxa)
    pm = jlik.transition_matrices(jm, jnp.asarray(jarr.blen))
    pip = np.zeros((1, A_PAD), np.float32)
    pip[0, :20] = jm.pi
    tile = chosen_tile(len(taxa) + jarr.children.shape[0])
    padded = np.full((len(taxa), -(-N_SITES // tile) * tile), PAD, np.int8)
    padded[:, :N_SITES] = codes
    want = pruning_site_ll_pallas(
        jnp.asarray(padded), jnp.asarray(jarr.children, jnp.int32),
        block_diag_pmats(pm), jnp.asarray(pip), interpret=True,
        mode="highest")
    got = ttc.per_site_log_likelihoods([parse_newick(jto_newick(nj))],
                                       codes, taxa, tm, device="cpu")
    _close(got[0], np.asarray(want)[:N_SITES])


def test_binary_trees_take_one_batch_and_polytomies_another(scored):
    codes, taxa, trees, jm, tm = scored
    port = [parse_newick(jto_newick(t)) for t in trees]
    batches = ttc.tree_batches(port, taxa, "cpu")
    assert len(batches) == 1 and batches[0][0] == [0, 1, 2, 3]
    assert batches[0][1].shape == (4, N_TAXA - 2, 3)
    # a 3-child internal node below the root: one internal node fewer
    poly = "((t0:0.1,t1:0.2,t2:0.1):0.1,(t3:0.1,t4:0.2):0.1,(t5:0.1,(t6:0.2,t7:0.1):0.05):0.1);"
    mixed = [port[0], parse_newick(poly), port[2]]
    batches = ttc.tree_batches(mixed, taxa, "cpu")
    assert [b[0] for b in batches] == [[0, 2], [1]]
    want = jtc.per_site_log_likelihoods(
        [trees[0], jparse(poly), trees[2]], codes, taxa, jm)
    _close(ttc.per_site_log_likelihoods(mixed, codes, taxa, tm,
                                        device="cpu"), want)


ROOTED = [
    # both root edges without a length: the root-to-root path is 0.2
    ("((t0:0.1,t1:0.2),((t2:0.1,t3:0.2):0.1,(t4:0.1,(t5:0.2,(t6:0.1,t7:0.2):0.1):0.1):0.3));",
     N_TAXA - 2),
    # one root edge without a length: x + 0.1
    ("((t0:0.1,t1:0.2):0.05,((t2:0.1,t3:0.2):0.1,(t4:0.1,(t5:0.2,(t6:0.1,t7:0.2):0.1):0.1):0.3));",
     N_TAXA - 2),
    # a leaf under the root without a length, a zero root edge
    ("(t0,(t1:0.2,((t2:0.1,t3:0.2):0.1,(t4:0.1,(t5:0.2,(t6:0.1,t7:0.2):0.1):0.1):0.3):0));",
     N_TAXA - 2),
    # a trifurcation under a bifurcating root: the root stays (the
    # binary trees' shape, the root's 2 rows in place of one 3-child row)
    ("((t0:0.1,t1:0.2,t2:0.3):0.2,((t3:0.1,t4:0.2):0.1,(t5:0.3,(t6:0.1,t7:0.2):0.1):0.2):0.1);",
     N_TAXA - 2),
    # the trifurcation second: the root's first child survives with 3
    # children, the trifurcation stays one (a polytomy's shape)
    ("(((t3:0.1,t4:0.2):0.1,(t5:0.3,(t6:0.1,t7:0.2):0.1):0.2),(t0:0.1,t1:0.2,t2:0.3));",
     N_TAXA - 3),
]


@pytest.mark.parametrize("nwk,n_int", ROOTED)
def test_rooted_trees_score_as_jax(scored, nwk, n_int):
    """Rooted trees as the JAX package scores them: missing root-edge
    lengths take tree_to_arrays' 0.1 before the merge, and a root whose
    surviving child would get 4 children is kept."""
    codes, taxa, trees, jm, tm = scored
    port = parse_newick(nwk)
    ((idx, ch, _),) = ttc.tree_batches([port], taxa, "cpu")
    assert ch.shape == (1, n_int, 3)
    want = jtc.per_site_log_likelihoods([jparse(nwk)], codes, taxa, jm)
    _close(ttc.per_site_log_likelihoods([port], codes, taxa, tm,
                                        device="cpu"), want)


TREE_PAIRS = [
    ("((A:0.1,B:0.2):0.3,(C:0.1,D:0.4):0.2,E:0.5);",
     "((A:0.2,C:0.2):0.1,(B:0.3,D:0.1):0.2,E:0.4);"),
    # different taxon sets (F only in the first, G only in the second),
    # a bifurcating root, a missing length
    ("(((A:0.1,B:0.2):0.3,(C:0.1,F:0.4):0.2):0.1,(D:0.3,E:0.5):0.2);",
     "((A:0.2,(B:0.3,C:0.1)):0.1,(D:0.1,G:0.2):0.2,E:0.4);"),
    ("((A,B),(C,D),E);", "((A,B),(C,D),E);"),
]


@pytest.mark.parametrize("nwk1,nwk2", TREE_PAIRS)
def test_compare_trees_and_branch_score_match_jax(nwk1, nwk2):
    j1, j2 = jparse(nwk1), jparse(nwk2)
    t1, t2 = parse_newick(nwk1), parse_newick(nwk2)
    want, got = jtc.compare_trees(j1, j2), ttc.compare_trees(t1, t2)
    assert sorted(got) == sorted(want)
    assert got["rf"] == want["rf"]
    assert got["common_taxa"] == want["common_taxa"]
    for k in ("branch_score", "branch_score_normalized"):
        assert abs(got[k] - want[k]) <= BSD_TOL
    for norm in (True, False):
        assert abs(ttc.branch_score_distance(t1, t2, norm)
                   - jtc.branch_score_distance(j1, j2, norm)) <= BSD_TOL
    a, b = ttc.restrict_to_common_taxa(t1, t2)
    ja, jb = jtc.restrict_to_common_taxa(j1, j2)
    assert to_newick(a) == jto_newick(ja) and to_newick(b) == jto_newick(jb)


def _site_lls(seed: int, T: int = 4, L: int = 400):
    """(T, L) site log-likelihoods of close competitors (so that no tree
    wins every replicate) and one clearly worse tree."""
    rng = np.random.default_rng(seed)
    base = -rng.gamma(2.0, 3.0, size=L)
    sl = base[None, :] + rng.normal(0.0, 0.4, size=(T, L))
    sl[-1] -= 0.5
    return sl.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_au_test_identical(seed):
    sl = _site_lls(seed)
    want = jau.au_test(sl, n_reps=300, seed=seed + 7)
    got = tau.au_test(sl, n_reps=300, seed=seed + 7)
    for f in ("au", "np_bp", "obs_diff", "d", "c"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert 0 < got.au.max() and got.au.min() < 1
    assert tau.au_report(got) == jau.au_report(want)
    names = [f"t{i}" for i in range(len(sl))]
    assert tau.au_report(got, names) == jau.au_report(want, names)
    assert np.array_equal(tau._phi_inv(np.array([0.05, 0.5, 0.9])),
                          jau._phi_inv(np.array([0.05, 0.5, 0.9])))


@pytest.fixture(scope="module")
def genomes():
    """4 ingroup genomes and 2 pool genomes of ~40 proteins, as both
    packages' SequenceSets over the same code arrays."""
    ingroup, pool, _ = simulate_genomes(
        np.random.default_rng(3), n_ingroup=4, n_pool=2, n_families=40,
        n_random=4, median_len=90.0, max_len=200, n_long=0)
    jin = [JSequenceSet(g.name, list(g.titles), list(g.seqs))
           for g in ingroup]
    jpool = [JSequenceSet(g.name, list(g.titles), list(g.seqs))
             for g in pool]
    return ingroup, pool, jin, jpool


@pytest.mark.parametrize("k,size", [(9, 10000), (5, 64)])
def test_minhash_sketches_and_distances_identical(genomes, k, size):
    ingroup, pool, jin, jpool = genomes
    for g, jg in zip(ingroup + pool, jin + jpool):
        got, want = tnm.minhash_sketch(g, k, size), \
            jnm.minhash_sketch(jg, k, size)
        assert got.dtype == np.uint64 and np.array_equal(got, want)
        assert 0 < len(got) <= size
    d, sk = tnm.distance_matrix(ingroup + pool, k, size)
    jd, jsk = jnm.distance_matrix(jin + jpool, k, size)
    assert np.array_equal(d, jd)
    assert all(np.array_equal(a, b) for a, b in zip(sk, jsk))
    assert tnm.mash_distance(sk[0], np.zeros(0, np.uint64), k) == 1.0
    assert 0.0 < d[0, 1] < 1.0


def test_mash_nj_tree_and_outgroups_identical(genomes):
    ingroup, pool, jin, jpool = genomes
    got = to_newick(tnm.mash_nj_tree(ingroup + pool))
    assert got == jto_newick(jnm.mash_nj_tree(jin + jpool))
    for count in (1, 2):
        picked = tnm.select_outgroups_by_distance(ingroup, pool, count)
        assert picked == jnm.select_outgroups_by_distance(jin, jpool, count)
        assert len(picked) == count


STATS_INPUTS = [
    (np.random.default_rng(0).normal(2.0, 1.5, 40),
     np.random.default_rng(1).normal(2.5, 1.0, 25)),
    (np.array([3.0]), np.array([3.0])),
    (np.array([1.0, 1.0, 1.0]), np.array([2.0, 5.0, 2.0, 9.0])),
]


@pytest.mark.parametrize("a,b", STATS_INPUTS)
def test_stats_identical(a, b):
    for fn in ("mean", "standard_deviation", "max_index"):
        assert getattr(tstats, fn)(a) == getattr(jstats, fn)(a)
    assert np.array_equal(tstats.z_scores(a), jstats.z_scores(a))
    assert tstats.t_statistic(a, b) == jstats.t_statistic(a, b)
    x = np.concatenate([a, b])
    y = 0.5 * x + np.sin(x)
    # nan (a constant x) counts as equal to nan
    assert np.array_equal(tstats.r_squared(x, y), jstats.r_squared(x, y),
                          equal_nan=True)
    for k in (1, 2, 3):
        gc, ga = tstats.kmeans_1d(x, k, seed=k)
        wc, wa = jstats.kmeans_1d(x, k, seed=k)
        assert np.array_equal(gc, wc) and np.array_equal(ga, wa)
    for bins in (3, 10):
        for g, w in zip(tstats.histogram(x, bins), jstats.histogram(x, bins)):
            assert np.array_equal(g, w)


# -- chip_smoke.py's tools phase, rehearsed on the CPU ----------------------

def _chip_smoke():
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tools_phase_rehearsal(tmp_path):
    """tool_trees, the AU verdicts (whole and by family), the six CLIs
    (`-device cpu`) and builder_runs at 12 taxa x ~2,000 columns and 3 +
    1 small genomes, on
    the CPU: every check the tools phase makes on the card passes."""
    from pepr_tpu_torch.io.fasta import SequenceSet
    from pepr_tpu_torch.models.concat import concatenate
    from pepr_tpu_torch.models.msa import Alignment
    from pepr_tpu_torch.models.treebuild import nj_tree
    from pepr_tpu_torch.utils.simulate import simulate_families
    cs = _chip_smoke()
    dev = torch.device("cpu")
    rng = np.random.default_rng(4)
    taxa = [f"taxon{i:02d}" for i in range(12)]
    truth = random_tree(taxa, rng)
    fams = simulate_families(truth, rng.integers(100, 250, size=12), rng,
                             alpha=0.5, absent=0.1)
    cat = concatenate([Alignment(n, t, c) for n, t, c in fams], taxa)
    full = nj_tree(cat.mat, taxa, device=dev)
    support = [truth] + [random_tree(taxa, rng) for _ in range(3)]
    ingroup, pool, _ = simulate_genomes(
        np.random.default_rng(5), n_ingroup=3, n_pool=1, n_families=30,
        n_random=3, median_len=80.0, max_len=160, n_long=0)
    groups = []
    for f in range(30):
        members = [(t, s) for g in ingroup + pool
                   for t, s in zip(g.titles, g.seqs)
                   if t.startswith(f"fam{f:04d}_")]
        if len(members) >= 2:
            groups.append(SequenceSet(f"g{f}", *map(list, zip(*members))))
    trees = cs.tool_trees(truth, full, cat.mat, taxa, 0, dev)
    assert list(trees) == ["generating", "stage2_full", "nj", "nni1",
                           "nni2", "nni3", "nni4", "random"]
    assert len(ttc.tree_batches(list(trees.values()), taxa, dev)) == 1
    rows = ttc.per_site_log_likelihoods(list(trees.values()), cat.mat, taxa,
                                        device="cpu")
    b = cs.au_verdicts(rows, list(trees), cs.AU_REPS)
    assert b["by_tree"]["random"]["au"] < cs.AU_LEVEL
    fam = cs.family_au(rows, cat.spans[:cs.AU_FAMILIES], list(trees),
                       cs.AU_FAMILY_REPS)
    assert fam["families"] == cs.AU_FAMILIES and fam["fitted"] > 0
    c = cs.cli_runs(str(tmp_path), cat.mat, taxa, trees, rows, support,
                    ingroup, pool, groups, ["-device", "cpu"],
                    cs.AU_CLI_REPS)
    assert c["set_extractor"]["sets"] == len(groups) > 10
    assert c["tree_comparison"]["sitelh_max_abs_diff"] <= cs.SITELH_TOL
    d = cs.builder_runs(cat.mat[:, :1000].copy(), taxa, dev)
    assert sorted(d["methods"]) == sorted(cs.TOOLS_METHODS)
    assert sorted(d["trees"]) == sorted(cs.TOOLS_METHODS)
