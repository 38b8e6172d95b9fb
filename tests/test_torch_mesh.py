"""The port's mesh (`pepr_tpu_torch/parallel/mesh.py`) and entry points
(`pepr_tpu_torch/entry.py`) on the CPU: Gloo ranks spawned by
`run_ranks` (one thread each) held against `pepr_tpu.parallel.mesh` on
its 8 virtual devices.

Tolerances: mesh shapes equal to the JAX package's; `sharded_loglik`
within rel 1e-5 of JAX's `loglik` and `sharded_loglik`, on a column
count that no site axis divides; `sharded_replicate_blopt` on the (2, 2)
mesh, 3 replicates, within lengths rtol 1e-3 and LLs rtol 1e-5 of JAX's
on its (2, 4) mesh, for jackknife masks and bootstrap counts (compacted
codes) and dense weights (shared codes, no compaction);
support topologies RF 0 to JAX's batched supports; every rank's results
identical to rank 0's; the mesh (1, 1) and a world of one rank bit for
bit the one-process path.  Every multi-rank call has its own timeout,
and a failing rank ends every rank."""

import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from pepr_tpu.models import support as jsup
from pepr_tpu.models.concat import concatenate as jconcat
from pepr_tpu.models.msa import Alignment as JAlignment
from pepr_tpu.models.treebuild import nj_start_tree as jnj
from pepr_tpu.ops import likelihood as jlik
from pepr_tpu.parallel import mesh as jmesh
from pepr_tpu.tree import to_newick as jto_newick

import torch_mesh_ranks as ranks
from pepr_tpu_torch import entry as tentry
from pepr_tpu_torch.device import rank_device
from pepr_tpu_torch.io.fasta import write_fasta
from pepr_tpu_torch.models.concat import concatenate as tconcat
from pepr_tpu_torch.models.msa import Alignment as TAlignment
from pepr_tpu_torch.models.treebuild import _inv_softplus, _softplus
from pepr_tpu_torch.models.treebuild import adam_blopt
from pepr_tpu_torch.ops import _cuda
from pepr_tpu_torch.ops import likelihood as tlik
from pepr_tpu_torch.parallel import mesh as tmesh
from pepr_tpu_torch.parallel.replicates import (replicate_blopt,
                                                replicate_codes)
from pepr_tpu_torch.pipeline import cli as tcli
from pepr_tpu_torch.tree import parse_newick, rf_distance
from pepr_tpu_torch.utils.simulate import (random_tree, simulate_families,
                                           simulate_genomes)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240.0
STEPS = 20
SUPPORT = dict(reps=3, seed=11, bl_steps=30)


@pytest.fixture(scope="module")
def data():
    """8 taxa, 10 families with an odd column count, the generating
    tree, per-column weights, the model in both packages, and 3
    jackknife masks, 3 bootstrap count vectors and 3 dense weight
    vectors, each with NJ start trees."""
    rng = np.random.default_rng(23)
    taxa = [f"T{i}" for i in range(8)]
    tree = random_tree(taxa, rng)
    lengths = rng.integers(40, 90, size=10)
    lengths[0] += 1 - lengths.sum() % 2
    fams = simulate_families(tree, lengths, rng, alpha=0.7)
    j = jconcat([JAlignment(n, t, c) for n, t, c in fams])
    t = tconcat([TAlignment(n, tx, c) for n, tx, c in fams])
    assert t.length % 2 == 1
    arr = tlik.tree_to_arrays(tree, t.taxa)
    jm = jlik.WagModel.create(alpha=0.8)
    tm = tlik.from_jax_arrays(jm.eig, jm.u, jm.u_inv, jm.pi, jm.rates)
    masks = jsup.jackknife_gene_masks(j, 3, 4)
    boot = np.stack([jsup.bootstrap_weights(j.length, r, 5)
                     for r in range(3)])
    dense = rng.uniform(0.5, 1.5, size=(3, j.length)).astype(np.float32)
    fits = []
    for w in (masks, boot, dense):
        arrs = [jlik.tree_to_arrays(jnj(j.mat, j.taxa, m), j.taxa)
                for m in w]
        fits.append((w, np.stack([a.children for a in arrs]),
                     np.stack([a.blen for a in arrs]), STEPS))
    return dict(j=j, t=t, full=(arr.children, arr.blen),
                weights=rng.random(t.length).astype(np.float32), jm=jm,
                tm=tm, fits=fits)


@pytest.fixture(scope="module")
def jax_ref(data):
    mesh = jmesh.default_mesh()
    assert dict(mesh.shape) == {"rep": 2, "site": 4}
    j, jm, w = data["j"], data["jm"], data["weights"]
    ch, bl = data["full"]
    return dict(
        loglik=float(jlik.loglik(j.mat, ch, bl, jm, site_weights=w)),
        sharded=float(jmesh.sharded_loglik(mesh, j.mat, w, ch, bl, jm)),
        fits=[jmesh.sharded_replicate_blopt(mesh, j.mat, fw, fc, fb, jm,
                                            steps=s)
              for fw, fc, fb, s in data["fits"]],
        support=jsup.support_trees(j, SUPPORT["reps"], SUPPORT["seed"],
                                   model=jm,
                                   bl_steps=SUPPORT["bl_steps"]))


def _on_ranks(n, fn, *args):
    return tentry.run_ranks(n, fn, args, device="cpu", timeout=TIMEOUT,
                            threads=1)


@pytest.fixture(scope="module")
def two_ranks(data, tmp_path_factory):
    return _on_ranks(2, ranks.mesh_work, data["t"].mat, data["weights"],
                     data["full"], data["tm"], (), data["t"],
                     dict(SUPPORT, model=data["tm"]),
                     str(tmp_path_factory.mktemp("store")))


@pytest.fixture(scope="module")
def four_ranks(data):
    return _on_ranks(4, ranks.mesh_work, data["t"].mat, data["weights"],
                     data["full"], data["tm"], data["fits"], data["t"],
                     dict(SUPPORT, model=data["tm"]))


@pytest.mark.parametrize("n", range(1, 9))
def test_default_mesh_shape_matches_jax(n):
    want = dict(jmesh.default_mesh(devices=jax.devices()[:n]).shape)
    assert tmesh.mesh_shape(n) == want


def test_multi_node_layout():
    # rep across nodes, site within a node: the layout of the JAX
    # package's two processes of two devices (tests/dist_worker.py)
    assert tmesh.mesh_shape(4, 2) == {"rep": 2, "site": 2}
    assert tmesh.mesh_shape(8, 4) == {"rep": 2, "site": 4}
    assert tmesh.mesh_shape(16, 8) == {"rep": 2, "site": 8}
    assert tmesh.mesh_shape(4, axes=("rep",)) == {"rep": 4, "site": 1}
    with pytest.raises(ValueError, match="multiple"):
        tmesh.mesh_shape(6, 4)


@pytest.mark.parametrize("world", ["two_ranks", "four_ranks"])
def test_ranks_form_the_mesh_and_agree(world, request):
    outs = request.getfixturevalue(world)
    n = len(outs)
    shape = tmesh.mesh_shape(n)
    assert [o["rank"] for o in outs] == list(range(n))
    for o in outs:
        assert o["world"] == n and o["shape"] == shape
        assert o["coords"] == dict(zip(("rep", "site"),
                                       divmod(o["rank"], shape["site"])))
        assert o["total"] == outs[0]["total"]
        assert o["support"] == outs[0]["support"]
        for (b, ll), (b0, ll0) in zip(o["fits"], outs[0]["fits"]):
            np.testing.assert_array_equal(b, b0)
            np.testing.assert_array_equal(ll, ll0)


@pytest.mark.parametrize("world", ["two_ranks", "four_ranks"])
def test_sharded_loglik_matches_jax(world, request, jax_ref):
    for o in request.getfixturevalue(world):
        for want in (jax_ref["loglik"], jax_ref["sharded"]):
            assert abs(o["total"] - want) <= 1e-5 * abs(want), \
                (o["total"], want)


FITS = ["jackknife", "bootstrap", "dense"]


@pytest.mark.parametrize("which", FITS)
def test_sharded_replicate_blopt_matches_jax(which, four_ranks, jax_ref,
                                             data):
    k = FITS.index(which)
    compacted = replicate_codes(data["t"].mat, data["fits"][k][0],
                                "cpu")[0].dim() == 3
    assert compacted == (which != "dense")
    want_b, want_ll = jax_ref["fits"][k]
    got_b, got_ll = four_ranks[0]["fits"][k]
    assert got_b.shape == want_b.shape and got_ll.shape == want_ll.shape
    np.testing.assert_allclose(got_b, want_b, rtol=1e-3)
    np.testing.assert_allclose(got_ll, want_ll, rtol=1e-5)


@pytest.mark.parametrize("world", ["two_ranks", "four_ranks"])
def test_support_trees_match_jax(world, request, jax_ref):
    got = request.getfixturevalue(world)[0]["support"]
    assert len(got) == len(jax_ref["support"])
    for a, b in zip(got, jax_ref["support"]):
        assert rf_distance(parse_newick(a), parse_newick(jto_newick(b))) \
            == 0


def test_store_is_written_by_rank_zero_only(two_ranks):
    # each rank saved its own rank under one key: rank 0's stays
    assert [o["stored"] for o in two_ranks] == [0, 0]


def test_deadline_answers_with_rank_zero(two_ranks):
    # rank 0's budget is 1e6 s, rank 1's is spent: both answer as rank 0
    assert [o["deadline"] for o in two_ranks] == [(False, False, True)] * 2


def _parent_replicate_blopt(codes, rep_weights, rep_children, rep_blen,
                            model, steps, block):
    """The one-process fit as it was before the mesh came, verbatim but
    for the block size."""
    margs = tlik.model_tensors(model, "cpu")
    rep_weights = np.asarray(rep_weights, np.float32)
    blens, lls = [], []
    for r0 in range(0, rep_weights.shape[0], block):
        sl = slice(r0, r0 + block)
        codes_d, w_d = replicate_codes(codes, rep_weights[sl], "cpu")
        ch = torch.as_tensor(np.asarray(rep_children[sl], np.int32))
        theta0 = torch.as_tensor(
            _inv_softplus(np.asarray(rep_blen[sl], np.float64))
            .astype(np.float32))
        theta, _ = adam_blopt(codes_d, ch, theta0, margs, w_d, steps)
        blen = _softplus(theta)
        with torch.no_grad():
            ll = tlik.loglik_weighted(codes_d, ch, blen, *margs, w_d)
        blens.append(blen.numpy())
        lls.append(ll.numpy())
    return (np.concatenate(blens).astype(np.float32),
            np.concatenate(lls).astype(np.float64))


@pytest.mark.parametrize("which", FITS)
def test_single_rank_mesh_is_the_one_process_path(which, data,
                                                  monkeypatch):
    from pepr_tpu_torch.parallel import replicates
    monkeypatch.setattr(replicates, "BLOCK_REPS", 2)
    w, ch, bl, steps = data["fits"][FITS.index(which)]
    mesh = tmesh.default_mesh()
    assert not dist.is_initialized() and mesh == tmesh.Mesh.single()
    want = _parent_replicate_blopt(data["t"].mat, w, ch, bl, data["tm"],
                                   steps, 2)
    for got in (tmesh.sharded_replicate_blopt(mesh, data["t"].mat, w, ch,
                                              bl, data["tm"], steps=steps,
                                              device="cpu"),
                replicate_blopt(data["t"].mat, w, ch, bl, data["tm"],
                                steps=steps, device="cpu")):
        for g, x in zip(got, want):
            assert g.dtype == x.dtype
            np.testing.assert_array_equal(g, x)
    total = tmesh.sharded_loglik(mesh, data["t"].mat, data["weights"],
                                 *data["full"], data["tm"], device="cpu")
    assert total == tlik.loglik(data["t"].mat, *data["full"], data["tm"],
                                site_weights=data["weights"], device="cpu")


def test_world_of_one_rank_is_the_one_process_path(data):
    fit = data["fits"][0]
    (got,) = _on_ranks(1, ranks.mesh_work, data["t"].mat, data["weights"],
                       data["full"], data["tm"], [fit])
    assert got["shape"] == {"rep": 1, "site": 1}
    # the rank's one thread: the plain pruning's sums follow the threads
    torch.set_num_threads(1)
    try:
        total = tlik.loglik(data["t"].mat, *data["full"], data["tm"],
                            site_weights=data["weights"], device="cpu")
        want = replicate_blopt(data["t"].mat, *fit[:3], data["tm"],
                               steps=fit[3], device="cpu")
    finally:
        torch.set_num_threads(2)
    assert got["total"] == total
    for g, x in zip(got["fits"][0], want):
        np.testing.assert_array_equal(g, x)


def test_initialize_distributed_without_coordinator(monkeypatch):
    monkeypatch.delenv("PEPR_COORDINATOR", raising=False)
    assert tmesh.initialize_distributed(device="cpu") is False
    assert not dist.is_initialized()
    assert tmesh.is_writer() and tmesh.rank0_value(2.5) == 2.5


ENV_RANK = """
import sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from pepr_tpu_torch.parallel import mesh as pm
assert pm.initialize_distributed(device="cpu")
m = pm.default_mesh()
print("MESH", pm.dist.get_rank(), m.shape["rep"], m.shape["site"],
      pm.rank0_value(float(pm.dist.get_rank() + 7)), flush=True)
pm.shutdown_distributed()
"""


@pytest.mark.parametrize("how", ["host_port", "auto"])
def test_initialize_distributed_from_the_environment(how):
    """PEPR_COORDINATOR=host:port with PEPR_NUM_PROCS / PEPR_PROC_ID, and
    PEPR_COORDINATOR=auto with the variables torchrun sets."""
    port = tentry.free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ)
        if how == "host_port":
            env.update(PEPR_COORDINATOR=f"127.0.0.1:{port}",
                       PEPR_NUM_PROCS="2", PEPR_PROC_ID=str(r))
        else:
            env.update(PEPR_COORDINATOR="auto", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), RANK=str(r), WORLD_SIZE="2",
                       LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="2")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", ENV_RANK.format(root=ROOT)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(out.split("MESH")[1].split())
    finally:
        for p in procs:
            p.kill()
    assert outs == [["0", "1", "2", "7.0"], ["1", "1", "2", "7.0"]]


def test_dryrun_multi_and_entry_on_the_cpu(capsys):
    outs = tentry.dryrun_multi(4, device="cpu")
    assert [o["mesh"] for o in outs] == [{"rep": 2, "site": 2}] * 4
    assert [o["coords"] for o in outs] == [
        {"rep": i, "site": j} for i in range(2) for j in range(2)]
    assert all(o["backend"] == "gloo" for o in outs)
    assert "dryrun_multi OK on 4 ranks" in capsys.readouterr().out
    fn, args = tentry.entry(device="cpu")
    codes, _, arr, model = tentry._tiny_problem()
    with torch.no_grad():
        assert float(fn(*args)) == tlik.loglik(codes, arr.children,
                                               arr.blen, model,
                                               device="cpu")
    assert tentry.main(["--device", "cpu"]) == 0


def test_failing_rank_ends_every_rank():
    t = time.time()
    with pytest.raises(RuntimeError, match="planted failure on rank 1"):
        _on_ranks(2, ranks.fail_on_rank_one)
    assert time.time() - t < TIMEOUT


def test_cli_over_two_ranks_writes_once(tmp_path, capsys):
    """The CLI in a group of 2 ranks: rank 0 alone prints the tree and
    writes the files and the store, and the tree is the one-rank run's."""
    ing, pool, _ = simulate_genomes(
        np.random.default_rng(61), n_ingroup=4, n_families=16, n_random=2,
        median_len=80.0, max_len=120, n_long=0)
    files = []
    for g in ing + pool:
        files.append(str(tmp_path / f"{g.taxon}.faa"))
        write_fasta(files[-1], g)

    def argv(tag):
        return ["-run_name", "cli", "-genome_file", *files[:-1], "-outgroup",
                files[-1], "-outgroup_count", "1", "-track", "fast",
                "-support_reps", "4", "-refine", "false", "-device", "cpu",
                "-out_dir", str(tmp_path / tag), "-checkpoint",
                str(tmp_path / f"ck_{tag}")]

    torch.set_num_threads(1)  # as in the ranks
    try:
        assert tcli.main(argv("one")) == 0
    finally:
        torch.set_num_threads(2)
    one = capsys.readouterr().out.strip().splitlines()[-1]
    outs = _on_ranks(2, ranks.cli_run, argv("two"))
    assert outs[0][0].strip().splitlines()[-1] == one
    assert outs[1][0] == ""
    assert [o[1] for o in outs] == [[0], []]
    assert outs[0][2] and outs[1][2] == []
    assert sorted(os.listdir(tmp_path / "two")) == \
        sorted(os.listdir(tmp_path / "one"))
    assert sorted(os.listdir(tmp_path / "ck_two")) == \
        sorted(os.listdir(tmp_path / "ck_one"))
    for f in ("cli.nwk", "cli_final_rooted.nwk"):
        assert (tmp_path / "two" / f).read_text() == \
            (tmp_path / "one" / f).read_text()


def test_nccl_refuses_ranks_sharing_a_card(monkeypatch):
    bound = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", bound.append)
    with pytest.raises(RuntimeError, match="NCCL cannot run two ranks"):
        rank_device(1, 2, "nccl")
    assert bound == []
    assert rank_device(3, 4, "gloo") == torch.device("cuda", 0)
    assert rank_device(0, 1, "nccl") == torch.device("cuda", 0)
    assert bound == [torch.device("cuda", 0)] * 2


FAKE_NVCC = """#!/bin/sh
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then shift; echo built > "$1"; fi
  shift
done
"""


def test_cuda_build_renames_library_and_stamp_into_place(tmp_path,
                                                         monkeypatch):
    """A build writes the library and its stamp to temporary files and
    renames them (a stand-in nvcc that writes its -o file)."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_cuda, "BUILD_DIR", str(tmp_path / "build"))
    logs = _cuda.build(("pruning", "sw"))
    assert sorted(logs) == ["pruning", "sw"]
    assert sorted(os.listdir(tmp_path / "build")) == [
        "libpepr_pruning.so", "libpepr_pruning.so.sha256",
        "libpepr_sw.so", "libpepr_sw.so.sha256"]
    for n in ("pruning", "sw"):
        with open(_cuda.lib_path(n) + ".sha256") as fh:
            assert fh.read() == _cuda._source_hash(n) + "\n"
    assert _cuda.build(("pruning", "sw")) == {}


def test_distributed_phase_rehearsal():
    """chip_smoke.py's distributed phase, parts (b) and (c), on the CPU
    at a small size: its rank function on 4 Gloo ranks and its checks
    against one process, on the small support input for both parts."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
        from pepr_tpu_torch.models.support import (jackknife_gene_masks,
                                                   support_trees_batched)
        from pepr_tpu_torch.models.treebuild import nj_start_tree
        from pepr_tpu_torch.tree import to_newick
        small = chip_smoke.small_support_input(0)
        model = tlik.WagModel.create(alpha=0.5)
        masks = jackknife_gene_masks(small, 4, 1)
        arrs = [tlik.tree_to_arrays(nj_start_tree(small.mat, small.taxa, m,
                                                  device="cpu"),
                                    small.taxa) for m in masks]
        ch = np.stack([a.children for a in arrs])
        bl = np.stack([a.blen for a in arrs])
        full = (arrs[0].children, arrs[0].blen)
        torch.set_num_threads(1)
        try:
            ones = np.ones(small.length, np.float32)
            b1, ll1 = replicate_blopt(small.mat, masks, ch, bl, model,
                                      steps=chip_smoke.DIST_STEPS,
                                      device="cpu")
            one = dict(
                total=tlik.loglik(small.mat, *full, model,
                                  site_weights=ones, device="cpu"),
                blen=b1, ll=ll1,
                support=[to_newick(t) for t in support_trees_batched(
                    small, chip_smoke.DIST_SMALL["reps"], 0,
                    device="cpu")])
        finally:
            torch.set_num_threads(2)
        outs = tentry.run_ranks(
            chip_smoke.DIST_RANKS, chip_smoke.dist_rank,
            (small.mat, masks, ch, bl, model, full, small, 0, "cpu",
             time.time()),
            device="cpu", timeout=TIMEOUT, threads=1)
        checks = chip_smoke.dist_checks(one, outs)
    finally:
        sys.path.remove(ROOT)
    assert checks["support_rf"] == [0] * chip_smoke.DIST_SMALL["reps"]
    assert all(checks["identical_across_ranks"])
    for o in outs:
        assert o["mesh"] == {"rep": 2, "site": 2}
        assert o["launches"] == {"pruning_fwd": 0, "pruning_bwd": 0}
        assert o["step_bytes"] == 2 * bl.shape[1] * 4
        assert o["collectives"]["all_reduce"] == chip_smoke.DIST_STEPS + 4
