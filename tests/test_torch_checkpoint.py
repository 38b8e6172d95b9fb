"""The port's checkpoint stores and soft time budget
(pepr_tpu_torch.pipeline.checkpoint, and the stages that save to a store
and poll a deadline) on the CPU.

A resumed run is held to the port's uninterrupted run exactly: Newick
strings with branch lengths, supports, log-likelihoods, alignments,
hits and counts.  Against the JAX package: the store and deadline
semantics are the same, a store it stamped is refused, its fingerprint
leaves out the alphabet where the port's does not (ROADMAP F6), and the
resumed ml_tree and alignments are held to its own under the tolerances
of tests/test_torch_treebuild.py (RF 0, LL rel 1e-4) and
tests/test_torch_msa.py (identical on families of 3 rows).  run_pepr
resumed against the JAX package is in tests/test_torch_pepr.py.

Interruptions come from chip_smoke.py's `Countdown` (a deadline that
runs out at its n-th poll) through its `interrupted_runs`, the loop its
resume phase runs on the card: each run resumes the store the last one
left."""

import importlib.util
import os
import pickle

import numpy as np
import pytest
import torch

from pepr_tpu.models import treebuild as jtb
from pepr_tpu.models.msa import align_families_chunked as j_chunked
from pepr_tpu.ops import likelihood as jlik
from pepr_tpu.pipeline import checkpoint as jck
from pepr_tpu.pipeline.pepr import PeprConfig as JPeprConfig
from pepr_tpu.tree import parse_newick as jparse
from pepr_tpu.tree import to_newick as jto_newick
from pepr_tpu.utils.simulate import simulate_alignment as jsimulate

from pepr_tpu_torch.models import msa as tmsa
from pepr_tpu_torch.models import support as tsup
from pepr_tpu_torch.models import treebuild as ttb
from pepr_tpu_torch.models.concat import concatenate
from pepr_tpu_torch.ops import likelihood as tlik
from pepr_tpu_torch.parallel import replicates
from pepr_tpu_torch.pipeline import checkpoint as ck
from pepr_tpu_torch.pipeline import pepr as tpepr
from pepr_tpu_torch.pipeline.checkpoint import (CheckpointStore, Deadline,
                                                FingerprintMismatch,
                                                Incomplete)
from pepr_tpu_torch.pipeline.pepr import PeprConfig, run_pepr
from pepr_tpu_torch.tree import parse_newick, rf_distance, to_newick
from pepr_tpu_torch.utils.simulate import (random_tree, simulate_families,
                                           simulate_genomes)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_STAMP = os.path.join(ROOT, "conformance", "aqu_ckpt", "_fingerprint.txt")


def _load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _load_smoke()


def _small_genomes(seed: int, n_families: int = 12):
    """4 ingroup genomes and a pool genome of `n_families` families and
    2 random proteins under 128 residues."""
    return simulate_genomes(
        np.random.default_rng(seed), n_ingroup=4, n_families=n_families,
        n_random=2, median_len=90.0, max_len=127, n_long=0)[:2]


def _tensors(obj, seen=None) -> list:
    """Every torch.Tensor or torch.device reachable from `obj`."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, (torch.Tensor, torch.device)):
        return [obj]
    if isinstance(obj, np.ndarray):
        return [] if obj.dtype != object else [
            t for x in obj.ravel() for t in _tensors(x, seen)]
    if isinstance(obj, dict):
        return [t for k, v in obj.items() for x in (k, v)
                for t in _tensors(x, seen)]
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [t for x in obj for t in _tensors(x, seen)]
    if hasattr(obj, "__dict__"):
        return _tensors(vars(obj), seen)
    return []


# -- the store and the deadline ----------------------------------------

def test_store_round_trip_cached_and_atomic_save(tmp_path):
    for mod in (ck, jck):
        store = mod.CheckpointStore(str(tmp_path / mod.__name__))
        assert not store.has("x")
        store.save("x", {"a": np.arange(3)})
        assert store.has("x")
        assert store.load("x")["a"].tolist() == [0, 1, 2]
        calls = []
        got = store.cached("x", lambda: calls.append(1) or "nope")
        assert calls == [] and isinstance(got, dict)
        assert store.cached("y", lambda: 7) == 7 and store.load("y") == 7

    class Unpicklable:
        def __reduce__(self):
            raise RuntimeError("no")

    # a save that fails half way leaves the previous value
    store = CheckpointStore(str(tmp_path / "atomic"))
    store.save("k", [1, 2, 3])
    with pytest.raises(RuntimeError):
        store.save("k", [4, Unpicklable()])
    assert store.load("k") == [1, 2, 3]


def test_deadline_semantics_match_jax():
    for seconds in (None, 0.0, 1000.0):
        a, b = Deadline(seconds), jck.Deadline(seconds)
        assert (a.t_end is None) == (b.t_end is None)
        assert a.expired == b.expired == (seconds == 0.0)
        for margin in (0.0, 90.0, 2000.0):
            assert a.near(margin) == b.near(margin)
        assert a.remaining() == pytest.approx(b.remaining(), abs=1.0)
    assert Deadline(None).remaining() == float("inf")
    assert Deadline(0.0).remaining() == 0.0
    assert Incomplete("mcl").stage == "mcl"
    assert "mcl" in str(Incomplete("mcl"))
    with pytest.raises(Incomplete):
        ck.check_deadline(Deadline(0.0), "x")
    ck.check_deadline(None, "x")
    ck.check_deadline(Deadline(None), "x")


def test_countdown_runs_out_at_its_nth_poll():
    c = smoke.Countdown(3)
    assert c.t_end is not None and c.remaining() > 0
    assert [c.expired, c.near(90.0), c.expired, c.near(1.0)] == \
        [False, False, True, True]
    assert c.remaining() == 0.0


# -- fingerprints ------------------------------------------------------

def test_fingerprint_mismatch_raises_and_clear_wipes(tmp_path):
    root = str(tmp_path / "s")
    store = CheckpointStore(root, fingerprint="a" * 16)
    store.save("x", 1)
    with pytest.raises(FingerprintMismatch):
        CheckpointStore(root, fingerprint="b" * 16)
    assert CheckpointStore(root, fingerprint="a" * 16).load("x") == 1
    store = CheckpointStore(root, fingerprint="b" * 16, on_mismatch="clear")
    assert not store.has("x")
    with open(os.path.join(root, "_fingerprint.txt")) as fh:
        assert fh.read() == "b" * 16
    # an unstamped directory is stamped on first open
    assert CheckpointStore(str(tmp_path / "new"), fingerprint="c" * 16)
    with open(tmp_path / "new" / "_fingerprint.txt") as fh:
        assert fh.read() == "c" * 16


def _jax_fingerprint(cfg) -> str:
    """The fingerprint the JAX package's run_pepr stamps a store with
    (pepr_tpu/pipeline/pepr.py:99-106)."""
    return jck.config_fingerprint(
        cfg.stage1, cfg.stage2, cfg.outgroup_count, cfg.min_taxa_multiplier,
        cfg.min_taxa, cfg.max_taxa, cfg.target_sets,
        [os.path.basename(p) for p in cfg.genome_files],
        [os.path.basename(p) for p in cfg.outgroup_files])


def test_jax_stamped_stores_are_refused(tmp_path):
    """A directory holding only a copy of conformance/aqu_ckpt's stamp
    (the JAX package's Aquificales store), and one stamped with the JAX
    fingerprint of the very configuration the port runs: both refused
    before anything is unpickled."""
    files = dict(genome_files=[f"g{i}.faa" for i in range(11)],
                 outgroup_files=["og.faa"])
    for i, stamp in enumerate((open(JAX_STAMP).read().strip(),
                               _jax_fingerprint(JPeprConfig.default_track(
                                   **files)))):
        root = tmp_path / f"jax{i}"
        root.mkdir()
        (root / "_fingerprint.txt").write_text(stamp)
        (root / "stage1.pkl").write_bytes(b"not a pickle of this package")
        cfg = PeprConfig.default_track(checkpoint_dir=str(root), **files)
        with pytest.raises(FingerprintMismatch):
            run_pepr(cfg, genomes=[], outgroup_pool=[], device="cpu")
    assert open(JAX_STAMP).read().strip() == "260a9311202a6fc2"


def test_alphabet_is_part_of_the_fingerprint(tmp_path):
    """An aa store, stamped by a protein run stopped at its first poll,
    is refused for a nucleotide run on genomes passed in memory; the JAX
    package's fingerprints of the two configurations are equal (F6)."""
    ing, pool = _small_genomes(71)
    root = str(tmp_path / "ck")
    with pytest.raises(Incomplete):
        run_pepr(PeprConfig(checkpoint_dir=root, time_budget=0.0, refine=False),
                 genomes=ing, outgroup_pool=pool, write_files=False,
                 device="cpu")
    nt = PeprConfig(checkpoint_dir=root, refine=False, alphabet="nt")
    with pytest.raises(FingerprintMismatch):
        run_pepr(nt, genomes=ing, outgroup_pool=pool, write_files=False,
                 device="cpu")
    assert _jax_fingerprint(JPeprConfig(alphabet="nt")) == \
        _jax_fingerprint(JPeprConfig(alphabet="aa"))


# -- the stages --------------------------------------------------------

def test_align_families_chunked_resumes(tmp_path):
    """tests/test_msa.py's case on the port: an expired deadline stops
    after every fresh slice, 3 stops for 7 families at chunk 2, and the
    result is align_families' and the JAX package's."""
    rng = np.random.default_rng(1234)
    fams = [[base.copy() for _ in range(3)] for base in
            (rng.integers(0, 20, size=40).astype(np.int8) for _ in range(7))]
    ref = tmsa.align_families(fams, device="cpu")
    store = CheckpointStore(str(tmp_path / "ck"))
    stops = 0
    while True:
        try:
            mats = tmsa.align_families_chunked(
                fams, store=store, deadline=Deadline(0.0), chunk=2,
                device="cpu")
            break
        except Incomplete as e:
            assert e.stage == "family alignment"
            stops += 1
    assert stops == 3
    assert sorted(os.listdir(store.root)) == [
        f"align_chunk_{i}.pkl" for i in range(4)]
    assert all(np.array_equal(a, b) for a, b in zip(ref, mats))
    want = j_chunked(fams, chunk=2)
    assert all(np.array_equal(a, b) for a, b in zip(want, mats))


@pytest.fixture(scope="module")
def eight_taxa():
    """tests/test_torch_treebuild.py's fixture and wrong start."""
    rng = np.random.default_rng(7)
    true = jparse("(((A:0.12,B:0.1):0.08,(C:0.1,D:0.12):0.09):0.05,"
                  "((E:0.1,F:0.12):0.1,(G:0.12,H:0.1):0.08):0.05);")
    codes, taxa = jsimulate(true, 600, rng)
    codes[rng.random(codes.shape) < 0.05] = 23
    start = "(((A:0.1,E:0.1):0.1,(C:0.1,D:0.1):0.1):0.1," \
            "((B:0.1,F:0.1):0.1,(G:0.1,H:0.1):0.1):0.1);"
    return codes, taxa, start


def test_ml_tree_resumes_at_every_round(eight_taxa, tmp_path):
    """ml_tree under countdowns, each run resuming the last one's store:
    stops before NNI rounds and before the SPR sweep; the end is the
    uninterrupted search's tree and LL exactly, and the JAX package's
    at RF 0, LL rel 1e-4 (8 rounds: the search converges in the fifth
    and sweeps)."""
    codes, taxa, start = eight_taxa
    kw = dict(nni_rounds=8, bl_steps=60, bl_refine_steps=30, spr_rounds=2)
    jm = jlik.WagModel.create(alpha=1.0)
    model = tlik.from_jax_arrays(jm.eig, jm.u, jm.u_inv, jm.pi, jm.rates)
    want, want_ll = ttb.ml_tree(codes, taxa, model, start=parse_newick(start),
                                device="cpu", **kw)
    root = str(tmp_path / "ck")
    stops = []

    def run(deadline):
        try:
            return ttb.ml_tree(codes, taxa, model, start=parse_newick(start),
                               store=CheckpointStore(root), deadline=deadline,
                               ckpt_key="full_tree_state", device="cpu", **kw)
        except Incomplete as e:
            stops.append(e.stage)
            raise

    (got, got_ll), saved, _ = smoke.interrupted_runs(run, root, restart=True)
    assert any(s.startswith("full-tree NNI round") for s in saved)
    assert any(s.startswith("full-tree SPR sweep") for s in stops)
    assert to_newick(got) == to_newick(want) and got_ll == want_ll
    state = CheckpointStore(root).load("full_tree_state")
    assert state[2] == got_ll and not _tensors(state)
    jt, j_ll = jtb.ml_tree(codes, taxa, jm, start=jparse(start), **kw)
    assert rf_distance(got, parse_newick(jto_newick(jt))) == 0
    assert got_ll == pytest.approx(j_ll, rel=1e-4)


def test_support_trees_resume_in_blocks_scores_and_refits(tmp_path,
                                                         monkeypatch):
    """support_trees_batched with blocks of 2 replicates over 12 taxa
    (3 of 5 replicates move in the first NNI round, 2 in the second):
    stops in the first fits' blocks, in a round's scores and in the
    moved replicates' refits; the end is the uninterrupted run's trees
    exactly, and the per-replicate keys let a finished store answer
    alone."""
    monkeypatch.setattr(replicates, "BLOCK_REPS", 2)
    rng = np.random.default_rng(23)
    tree = random_tree([f"T{i}" for i in range(12)], rng)
    cat = concatenate([tmsa.Alignment(n, t, c) for n, t, c in
                       simulate_families(tree, rng.integers(30, 60, size=8),
                                         rng, alpha=0.7)])
    kw = dict(bl_steps=30, device="cpu")
    want = tsup.support_trees(cat, 5, 11, **kw)
    root = str(tmp_path / "ck")
    got, saved, _ = smoke.interrupted_runs(
        lambda d: tsup.support_trees(cat, 5, 11, store=CheckpointStore(root),
                                     deadline=d, **kw), root, restart=True)
    for stage in ("support BL-opt", "support NNI scoring round 0",
                  "support moved-BL-opt round 0",
                  "support moved-BL-opt round 1"):
        assert stage in saved, (stage, saved)
    assert [to_newick(t) for t in got] == [to_newick(t) for t in want]
    store = CheckpointStore(root)
    assert sorted(store.load("support_blopt_blocks")) == [0, 2, 4]
    assert sorted(store.load("support_moved_blopt_0")) == [0, 2]
    again = tsup.support_trees(cat, 5, 11, store=store, deadline=Deadline(0.0),
                               **kw)
    assert [to_newick(t) for t in again] == [to_newick(t) for t in want]


# -- run_pepr ----------------------------------------------------------

REPS = 4


def _pepr_config(**kw):
    """tests/test_torch_pepr.py's small configuration."""
    cfg = PeprConfig.default_track(run_name="small", **kw)
    cfg.stage1.hmm_min_bits = 40.0
    cfg.stage2.full_tree_method = "fast_ml"
    cfg.stage2.support_reps = REPS
    cfg.refine_cutoff = float(REPS)
    return cfg


@pytest.fixture(scope="module")
def pepr_runs(tmp_path_factory):
    """tests/test_torch_pepr.py's small_runs input (5 + 1 genomes, one
    refinement round): the port's run without a store, and a chain of
    runs under countdowns put in place of the pipeline's Deadline, each
    resuming the store the last one left, every run restarting its
    countdown after each stop that saved work."""
    g = [f"Synthica_spec{i:02d}_strain_X" for i in range(5)]
    tree = parse_newick(f"((({g[0]}:0.05,{g[1]}:0.05):0.00001,{g[2]}:0.05)"
                        f":0.08,({g[3]}:0.06,{g[4]}:0.07):0.08);")
    ing, pool, _ = simulate_genomes(
        np.random.default_rng(5), n_ingroup=5, n_pool=1, n_families=30,
        n_random=4, median_len=90.0, max_len=127, n_long=0,
        ingroup_tree=tree)
    d = str(tmp_path_factory.mktemp("pepr"))
    want = run_pepr(_pepr_config(out_dir=d), genomes=ing, outgroup_pool=pool,
                    write_files=False, device="cpu")
    root = os.path.join(d, "ck")
    in_sub = []
    mp = pytest.MonkeyPatch()

    def run(deadline):
        mp.setattr(tpepr, "Deadline",
                   lambda s: deadline if s is not None else Deadline(None))
        return run_pepr(_pepr_config(out_dir=d, checkpoint_dir=root,
                                     time_budget=1.0),
                        genomes=ing, outgroup_pool=pool, write_files=False,
                        device="cpu")

    try:
        got, saved, runs = smoke.interrupted_runs(
            run, root, restart=True,
            on_stop=lambda s: in_sub.append(os.path.isdir(
                os.path.join(root, "sub1"))))
    finally:
        mp.undo()
    return want, got, saved, in_sub, root


def test_run_pepr_resumed_at_every_saved_poll_is_the_whole_run(pepr_runs):
    want, got, saved, in_sub, _ = pepr_runs
    for stage in ("homology SW", "mcl", "group alignment",
                  "profile HMM scoring", "alignment", "alpha estimation",
                  "full-tree NNI round 0", "full tree", "support BL-opt",
                  "support NNI scoring round 0"):
        assert stage in saved, (stage, saved)
    # stage 1, stage 2, and the same inside the refinement sub-run
    assert not in_sub[0] and in_sub[-1]
    assert saved[in_sub.index(True)] == "homology SW"
    assert got.newick == want.newick
    assert to_newick(got.stage2.full_tree) == to_newick(want.stage2.full_tree)
    assert got.stage2.log_likelihood == want.stage2.log_likelihood
    assert [to_newick(t) for t in got.stage2.support_trees] == \
        [to_newick(t) for t in want.stage2.support_trees]
    assert got.selected_outgroups == want.selected_outgroups
    assert got.stage1_counts == want.stage1_counts
    assert got.refine_rounds == want.refine_rounds == 1
    assert set(got.timings) == set(want.timings)


def test_finished_store_keys_and_host_values(pepr_runs):
    """The JAX package's keys, a sub-store for the refinement round, and
    no tensor or device anywhere in what the store holds."""
    *_, root = pepr_runs
    names = set(os.listdir(root))
    for key in ("stage1", "s1_hits", "s1_sw_pairs", "s1_sw_out",
                "s1_clusters", "hmm_group_alignments", "hmm_align_chunk_0",
                "hmm_pairs", "hmm_viterbi", "hmm_scores", "alignments",
                "s2_align_chunk_0", "gamma_alpha", "full_tree",
                "full_tree_state", "support_starts", "support_blopt_blocks",
                "support_batch_state", "support_nni_scores_0",
                *(f"support_{r:04d}" for r in range(REPS))):
        assert f"{key}.pkl" in names, key
    assert "sub1" in names and "stage1.pkl" in os.listdir(
        os.path.join(root, "sub1"))
    found = []
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".pkl"):
                with open(os.path.join(d, f), "rb") as fh:
                    found += [(f, type(t)) for t in _tensors(pickle.load(fh))]
            else:
                assert f == "_fingerprint.txt", f
    assert not found


def test_smoke_resume_phase_rehearsed_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's resume (c) on the CPU on a smaller input (4 + 1
    genomes of 8 families, 3 replicates, slices of 3 families): every
    required stage named, each resumed from its first stop, and the
    chain's end, identical to the whole run."""
    monkeypatch.setattr(smoke, "RESUME_CHUNK", 3)
    ing, pool = _small_genomes(13, n_families=8)
    out = smoke.small_resume(ing, pool, str(tmp_path), torch.device("cpu"),
                             reps=3)
    assert out["missing"] == [] and out["chain_differ"] == []
    assert set(out["resumed"]) == set(smoke.RESUME_STAGES)
    assert all(v["differ"] == [] for v in out["resumed"].values())
    assert tmsa.ALIGN_CHUNK == 512  # put back
