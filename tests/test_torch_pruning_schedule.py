"""The host side of the pruning kernels (pepr_tpu_torch.ops.pruning):
the slot plan, and the kernels' schedule emulated in PyTorch on the CPU.

`plan_slots` is checked on random postorder trees up to MAX_NODES: no
shared-memory slot is given to a node while another live node holds it,
no slot is reused by the node that reads it, the children's slots in a
plan row are the children's own, and the spill counts are right.

`emulate` replays, in plain float32 PyTorch, what csrc/pruning.cu does
with a plan: tiles of 32 * R sites walked by n_chunks blocks, partials
stored unscaled with their per-category maxima in shared slots or spill
records, scaled on read by the shared factor, the log factors summed as
children are read, the root's LL, and for the gradient every record
kept, the coefficient ct / (m_u sum_c dot_c), upper messages in their own slots, M^ (x) D per internal edge, the
column add by code per leaf edge, and the per-block slots summed in
order.  It is held against `site_ll_reference` /
`site_ll_grad_reference` and against the JAX package's Pallas kernels
in interpret mode, with the chip tolerances: per-site LL rel 1e-5
(+1e-5 absolute), gradient max |diff| <= 1e-4 * max |ref|.  This
emulation is test code; the package holds only the plan."""

import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pepr_tpu.ops import likelihood as jlik
from pepr_tpu.ops.pallas_pruning import (A_PAD, block_diag_pmats,
                                         pruning_site_ll_pallas)
from pepr_tpu.ops.pallas_pruning_grad import pruning_grad_pmats_pallas
from pepr_tpu.tree import parse_newick as jparse
from pepr_tpu.utils.simulate import simulate_alignment as jsimulate

from pepr_tpu_torch.ops import likelihood as tlik
from pepr_tpu_torch.ops import pruning
from pepr_tpu_torch.utils.simulate import random_tree

torch.set_num_threads(2)
FWD_RTOL = 1e-5
BWD_RTOL = 1e-4
NA = 20
OFF_CODE = NA + 4


# -- random postorder trees ----------------------------------------------------

def random_children(rng, n_leaves, root3=True, shape="random"):
    """(n_int, 3) children of a random tree over n_leaves leaves in the
    kernel's postorder (internal node ids n_leaves + i, root last):
    'random' joins random pairs, 'caterpillar' a chain, 'balanced'
    neighbours level by level."""
    pool = list(rng.permutation(n_leaves))
    rows = []

    def join(kids):
        rows.append(list(kids) + [-1] * (3 - len(kids)))
        return n_leaves + len(rows) - 1

    stop = 3 if root3 else 2
    while len(pool) > stop:
        if shape == "caterpillar":
            a, b = pool.pop(), pool.pop()
            pool.append(join([a, b]))
        elif shape == "balanced":
            nxt = []
            while len(pool) >= 2 and len(pool) + len(nxt) > stop:
                nxt.append(join([pool.pop(0), pool.pop(0)]))
            pool = nxt + pool
        else:
            i, j = sorted(rng.choice(len(pool), 2, replace=False))
            b, a = pool.pop(j), pool.pop(i)
            pool.insert(int(rng.integers(0, len(pool) + 1)), join([a, b]))
    join(pool)
    return np.array(rows, np.int32)


def _check_forward_plan(plan, n_leaves, cap_f, stats_tree):
    n_int = plan.shape[0]
    live = {}  # slot -> node
    spilled = []
    for i in range(n_int):
        row = plan[i]
        for k in range(3):
            v = row[k]
            if v >= n_leaves:
                assert row[4 + k] == plan[v - n_leaves, 3]
        if i == n_int - 1:
            break
        s = row[3]
        if s >= 0:
            assert s < cap_f
            assert s not in live, (i, s, live)
            live[s] = i
        else:
            spilled.append(-s - 1)
        for k in range(3):
            v = row[k]
            if v >= n_leaves and plan[v - n_leaves, 3] >= 0:
                assert live.pop(plan[v - n_leaves, 3]) == v - n_leaves
    assert sorted(spilled) == list(range(len(spilled)))  # one record each
    assert stats_tree == len(spilled)


def _check_upper_plan(plan, n_leaves, cap_u):
    n_int = plan.shape[0]
    live = {}
    spilled = []
    for i in range(n_int - 1, -1, -1):
        row = plan[i]
        if i != n_int - 1:
            assert row[7] < 0 or live.get(row[7]) == i
        for k in range(3):
            v = row[k]
            if v < n_leaves:
                continue
            s = plan[v - n_leaves, 7]
            assert row[8 + k] == s
            if s >= 0:
                assert s < cap_u and s not in live, (i, s, live)
                live[s] = v - n_leaves
            else:
                spilled.append(-s - 1)
        if i != n_int - 1 and row[7] >= 0:
            del live[row[7]]
    assert sorted(spilled) == list(range(len(spilled)))
    return len(spilled)


@pytest.mark.parametrize("n_leaves,shape,cap", [
    (8, "random", 62), (53, "random", 62), (53, "random", 3),
    (53, "caterpillar", 1), (53, "balanced", 2), (300, "random", 4),
    (300, "balanced", 0), (pruning.MAX_NODES // 2, "random", 8),
    (pruning.MAX_NODES // 2 - 1, "balanced", 6)])
def test_slot_plan_never_reuses_a_live_slot(n_leaves, shape, cap):
    rng = np.random.default_rng(n_leaves + cap)
    B = 3 if n_leaves < 1000 else 1
    root3 = bool(n_leaves % 2)
    ch = np.stack([random_children(rng, n_leaves, root3, shape)
                   for _ in range(B)])
    assert ch.shape[1] + n_leaves <= pruning.MAX_NODES
    plan, st = pruning.plan_slots(ch, n_leaves, cap, cap)
    assert plan.shape == (B, ch.shape[1], pruning.PLAN_W)
    np.testing.assert_array_equal(plan[:, :, :3], ch)
    counts_f, counts_u = [], []
    for b in range(B):
        nf = int((plan[b, :-1, 3] < 0).sum())
        _check_forward_plan(plan[b], n_leaves, cap, nf)
        counts_f.append(nf)
        counts_u.append(_check_upper_plan(plan[b], n_leaves, cap))
    assert st["spill_f"] == max(counts_f) and st["spilled_f"] == sum(counts_f)
    assert st["spill_u"] == max(counts_u) and st["spilled_u"] == sum(counts_u)
    assert st["slots_f"] <= cap and st["slots_u"] <= cap
    if cap >= 62:
        assert st["spilled_f"] == st["spilled_u"] == 0


def test_slot_plan_peak_is_the_live_set():
    """Uncapped, the forward slots used equal the largest live set over
    the postorder (a node and the unread partials before it)."""
    rng = np.random.default_rng(5)
    for shape in ("random", "caterpillar", "balanced"):
        ch = random_children(rng, 40, shape=shape)
        _, st = pruning.plan_slots(ch[None], 40, 62)
        live, peak = set(), 0
        for i, row in enumerate(ch[:-1]):
            live.add(i)
            peak = max(peak, len(live))
            live -= {v - 40 for v in row if v >= 40}
        assert st["slots_f"] == peak, shape
    # a caterpillar needs two slots (a node is placed before its child's
    # slot frees), spills nothing with them, and every non-root node
    # without any
    ch = random_children(rng, 30, shape="caterpillar")[None]
    assert pruning.plan_slots(ch, 30, 2, 2)[1]["spilled_f"] == 0
    assert pruning.plan_slots(ch, 30, 0, 0)[1]["spilled_f"] == ch.shape[1] - 1


# -- the schedule, emulated --------------------------------------------------

def _rescaled(i, n_int):
    return i % 2 == 1 or i == n_int - 1


def emulate(codes, children, pmats, pi, ct=None, *, R=1, cap_f=62,
            cap_u=62, n_chunks=2):
    """The kernels' arithmetic under a plan: site LL (B, L) and, with
    `ct`, the gradient (B, C, V, 20, 20)."""
    codes = torch.as_tensor(codes)
    children = np.asarray(children, np.int32)
    pmats = torch.as_tensor(np.array(pmats), dtype=torch.float32)
    pi = torch.as_tensor(pi, dtype=torch.float32)
    B, n_int = children.shape[:2]
    n_leaves, L = codes.shape[-2:]
    C, V = pmats.shape[1], pmats.shape[2]
    TS = 32 * R
    bwd = ct is not None
    plan, st = pruning.plan_slots(children, n_leaves, cap_f,
                                  cap_u if bwd else None)
    live = (pi > 1e-6).to(torch.float32)
    amb = torch.einsum("tcvab,b->tcva", pmats[:, :, :n_leaves], live)
    n_tiles = -(-L // TS)
    n_chunks = max(1, min(n_chunks, n_tiles))
    out = torch.zeros((B, L))
    grad = torch.zeros((B, C, V, NA, NA)) if bwd else None
    for b in range(B):
        cb = codes if codes.dim() == 2 else codes[b]
        P = pmats[b]  # (C, V, 20, 20)
        slots = []
        for x in range(n_chunks):
            g = torch.zeros((C, V, NA, NA))
            fsl = torch.full((max(st["slots_f"], 1), C, NA + 1, TS), math.nan)
            spill = torch.full((max(st["spill_f"], 1), C, NA + 1, TS),
                               math.nan)
            keep = torch.full((n_int, C, NA + 1, TS), math.nan)
            usl = torch.full((max(st["slots_u"], 1), C, NA, TS), math.nan)
            uspill = torch.full((max(st["spill_u"], 1), C, NA, TS), math.nan)

            def frec(node, fs):
                if fs >= 0:
                    return fsl[fs]
                return keep[node] if bwd else spill[-fs - 1]

            def urec(us):
                return usl[us] if us >= 0 else uspill[-us - 1]

            for tile in range(x, n_tiles, n_chunks):
                site = tile * TS + torch.arange(TS)
                valid = site < L
                tips = torch.full((n_leaves, TS), OFF_CODE, dtype=torch.long)
                tips[:, valid] = cb[:, site[valid]].long()

                def factor(rec):
                    return rec[:, NA].amax(0).clamp_min(1e-30)

                def term(k, v, rec_of):
                    """(C, 20, TS) term of child v (slot k of the row) and
                    the log factor it brings."""
                    if v < n_leaves:
                        code = tips[v]
                        ambig = (code < 0) | (code >= NA)
                        col = P[:, v][:, :, code.clamp(0, NA - 1)]
                        return torch.where(ambig[None, None],
                                           amb[b, :, v, :, None], col), 0.0
                    node = v - n_leaves
                    rec = rec_of(node)
                    if _rescaled(node, n_int):
                        m = factor(rec)
                        d = rec[:, :NA] * (1.0 / m)
                        lg = torch.log(m)
                    else:
                        d, lg = rec[:, :NA], 0.0
                    return torch.einsum("cab,cbs->cas", P[:, v], d), lg

                logscale = torch.zeros(TS)
                for i in range(n_int):
                    row = plan[b, i]
                    prod = torch.ones((C, NA, TS))
                    for k in range(3):
                        v = int(row[k])
                        if v < 0:
                            continue
                        t, lg = term(k, v, lambda n, k=k: frec(n, row[4 + k]))
                        logscale = logscale + lg
                        prod = prod * t
                    mx = prod.amax(1)
                    rec = torch.cat([prod, mx[:, None]], 1)
                    if i != n_int - 1:
                        frec(i, row[3])[:] = rec
                    if bwd:
                        keep[i] = rec
                # the root (last node): shared factor, then the site LL
                m = mx.amax(0).clamp_min(1e-30)
                logscale = logscale + torch.log(m)
                dot = torch.einsum("a,cas->cs", pi, prod * (1.0 / m))
                cat = torch.log(dot.clamp_min(1e-30))
                top = cat.amax(0)
                ssum = torch.exp(cat - top).sum(0)
                lrel = top + torch.log(ssum)  # log-sum-exp less logscale
                out[b, site[valid]] = (top + torch.log(ssum / C)
                                       + logscale)[valid]
                if not bwd:
                    continue
                cts = torch.zeros(TS)
                cts[valid] = torch.as_tensor(ct)[b, site[valid]].float()
                for i in range(n_int - 1, -1, -1):
                    row = plan[b, i]
                    lm = torch.log(factor(keep[i])) if _rescaled(i, n_int) \
                        else torch.zeros(TS)
                    coef = torch.exp(-lm - lrel) * cts
                    down = torch.exp(-lm)
                    u = pi[None, :, None].expand(C, NA, TS) \
                        if i == n_int - 1 else urec(row[7])
                    for k in range(3):
                        v = int(row[k])
                        if v < 0:
                            continue
                        M = u.clone()
                        for k2 in range(3):
                            v2 = int(row[k2])
                            if k2 == k or v2 < 0:
                                continue
                            M = M * term(k2, v2, lambda n: keep[n])[0]
                        Mh = M * coef
                        if v >= n_leaves:
                            node = v - n_leaves
                            rec = keep[node]
                            d = rec[:, :NA] * (1.0 / factor(rec)) \
                                if _rescaled(node, n_int) else rec[:, :NA]
                            g[:, v] += torch.einsum("cas,cbs->cab", Mh, d)
                            urec(row[8 + k])[:] = torch.einsum(
                                "cab,cas->cbs", P[:, v], M) * down
                        else:
                            code = tips[v]
                            col = torch.where((code < 0) | (code >= NA),
                                              NA, code)
                            acc = torch.zeros((C, NA, NA + 1))
                            acc.index_add_(2, col, Mh)
                            g[:, v] += acc[:, :, :NA] \
                                + acc[:, :, NA:] * live[None, None]
            slots.append(g)
        if bwd:
            tot = torch.zeros_like(slots[0])
            for gs in slots:  # in chunk order
                tot = tot + gs
            grad[b] = tot
    return out, grad


def _close(got, want, rtol, atol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= rtol * np.abs(want) + atol), \
        float(np.max(np.abs(got - want)))


def _close_norm(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.max(np.abs(got - want)) <= rtol * np.max(np.abs(want)), \
        (float(np.max(np.abs(got - want))), float(np.max(np.abs(want))))


@pytest.fixture(scope="module")
def batch53():
    """3 random 53-taxon trees (one generating tree, two others) over a
    100-column alignment with ambiguous codes, shared and per-tree
    codes."""
    rng = np.random.default_rng(11)
    taxa = [f"t{i:02d}" for i in range(53)]
    trees = [random_tree(taxa, rng) for _ in range(3)]
    codes = rng.integers(0, 20, size=(53, 100)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.1] = 23
    codes[:, 3] = 22
    arrs = [tlik.tree_to_arrays(t, taxa) for t in trees]
    model = tlik.WagModel.create(0.5)
    blen = torch.as_tensor(np.stack([a.blen for a in arrs]))
    pm = tlik.transition_matrices(model, blen).contiguous()
    ch = np.stack([a.children for a in arrs])
    ct = rng.random((3, 100)).astype(np.float32)
    per_tree = np.stack([codes, np.roll(codes, 7, axis=1),
                         np.roll(codes, 1, axis=0)])
    return codes, per_tree, ch, pm, torch.as_tensor(model.pi), ct


@pytest.mark.parametrize("R,caps", [(1, (62, 62)), (2, (62, 62)),
                                    (1, (3, 2)), (2, (0, 0))],
                         ids=["r1", "r2", "r1_spill", "r2_all_spilled"])
@pytest.mark.parametrize("per_tree", [False, True], ids=["shared", "per_tree"])
def test_emulated_schedule_matches_plain(batch53, R, caps, per_tree):
    codes, pt, ch, pm, pi, ct = batch53
    cd = torch.as_tensor(pt if per_tree else codes)
    chq = torch.as_tensor(ch)
    ll, g = emulate(cd, ch, pm, pi, ct, R=R, cap_f=caps[0], cap_u=caps[1],
                    n_chunks=2)
    ll_ref = pruning.site_ll_reference(cd, chq, pm, pi)
    g_ref = pruning.site_ll_grad_reference(cd, chq, pm, pi,
                                           torch.as_tensor(ct))
    _close(ll, ll_ref, FWD_RTOL, 1e-5)
    _close_norm(g, g_ref, BWD_RTOL)
    # the forward alone (spill records, no kept records) gives the same LL
    ll_f, _ = emulate(cd, ch, pm, pi, R=R, cap_f=caps[0], n_chunks=3)
    _close(ll_f, ll_ref, FWD_RTOL, 1e-5)


# 3-child root, 8 taxa; and a rooted binary tree (as in
# tests/test_torch_likelihood.py)
NWK = ("(((A:0.1,B:0.2):0.1,(C:0.15,D:0.1):0.2):0.05,"
       "(E:0.1,F:0.3):0.1,(G:0.2,H:0.1):0.15);")
NWK_ROOTED = "(((A:0.12,B:0.3):0.15,(C:0.1,D:0.25):0.2):0.1,(E:0.4,F:0.08):0.18);"


@pytest.fixture(scope="module", params=[NWK, NWK_ROOTED],
                ids=["root3", "root2"])
def problem(request):
    rng = np.random.default_rng(3)
    tree = jparse(request.param)
    codes, taxa = jsimulate(tree, 512, rng, alpha=0.8)
    codes[rng.random(codes.shape) < 0.08] = 23
    codes[0, 5] = 22
    codes[2, 40:60] = 20
    codes[:, 7] = 23
    return codes, jlik.tree_to_arrays(tree, taxa)


@pytest.mark.parametrize("R,cap", [(1, 62), (2, 1)], ids=["r1", "r2_spill"])
def test_emulated_schedule_matches_pallas_interpret(problem, R, cap):
    codes, jarr = problem
    jm = jlik.WagModel.create(alpha=0.8)
    pm = np.asarray(jlik.transition_matrices(jm, jnp.asarray(jarr.blen)))
    pip = np.zeros((1, A_PAD), np.float32)
    pip[0, :20] = jm.pi
    ct = np.random.default_rng(4).random(codes.shape[1]).astype(np.float32)
    want_ll = pruning_site_ll_pallas(
        jnp.asarray(codes), jnp.asarray(jarr.children, jnp.int32),
        block_diag_pmats(pm), jnp.asarray(pip), interpret=True,
        mode="highest")
    gbd = np.asarray(pruning_grad_pmats_pallas(
        jnp.asarray(codes), jnp.asarray(jarr.children, jnp.int32),
        block_diag_pmats(pm), jnp.asarray(pip), jnp.asarray(ct),
        interpret=True, mode="highest"))
    want_g = np.stack([gbd[:, c * A_PAD:c * A_PAD + 20,
                           c * A_PAD:c * A_PAD + 20] for c in range(4)])
    ll, g = emulate(codes, jarr.children[None], pm[None], jm.pi, ct[None],
                    R=R, cap_f=cap, cap_u=cap, n_chunks=3)
    _close(ll[0], want_ll, FWD_RTOL, 1e-5)
    _close_norm(g[0], want_g, BWD_RTOL)


@pytest.mark.parametrize("caps", [(62, 62), (3, 2), (0, 0), (5, None)])
def test_batch_plan_is_each_trees_own_plan(caps):
    """A batch is planned tree by tree: each tree's rows are its own plan,
    and the numbers are the most over the trees (slots, spills per tree)
    and the sum (spilled nodes)."""
    rng = np.random.default_rng(sum(c or 0 for c in caps))
    ch = np.stack([random_children(rng, 53, shape=s) for s in
                   ("random", "random", "balanced", "caterpillar")])
    plan, st = pruning.plan_slots(ch, 53, *caps)
    alone = [pruning.plan_slots(c, 53, *caps) for c in ch]
    for b, (p, _) in enumerate(alone):
        np.testing.assert_array_equal(plan[b], p[0])
    for key in ("slots_f", "slots_u", "spill_f", "spill_u"):
        assert st[key] == max(s[key] for _, s in alone), key
    for key in ("spilled_f", "spilled_u"):
        assert st[key] == sum(s[key] for _, s in alone), key
    if caps[1] is None:
        assert st["slots_u"] == st["spilled_u"] == 0
        assert (plan[:, :, 7:] == 0).all()


@pytest.mark.parametrize("B,n_tiles,resident", [
    (1, 504, 132), (4, 64, 132), (64, 253, 132), (512, 504, 132),
    (100, 253, 132), (2, 2, 132), (3, 1, 264)])
def test_blocks_per_tree_takes_fewest_rounds(B, n_tiles, resident):
    """The grid: of the block counts within two waves (and at most one
    block per tile), the one minimizing waves of resident blocks times
    the most tiles one block walks, fewest blocks on a tie."""
    n = pruning.blocks_per_tree(B, n_tiles, resident)
    allowed = range(1, max(1, min(n_tiles, -(-2 * resident // B))) + 1)

    def rounds(m):
        return -(-B * m // resident) * -(-n_tiles // m)

    assert n in allowed
    assert all(rounds(n) <= rounds(m) for m in allowed)
    assert all(rounds(m) > rounds(n) for m in range(1, n))


def test_emulated_gradient_holds_against_float64_on_a_large_tree():
    """500 taxa, every tip observed: site LLs near -2,000, where
    exp(logscale - log m - lse) loses more than 1e-4 to the difference
    of two large float32 logs.  The kernels' coefficient
    ct / (m sum_c dot_c) keeps the emulated gradient within 1e-4 of a
    float64 reference."""
    rng = np.random.default_rng(8)
    taxa = [f"t{i:04d}" for i in range(500)]
    arr = tlik.tree_to_arrays(random_tree(taxa, rng), taxa)
    model = tlik.WagModel.create(0.5)
    pm = tlik.transition_matrices(model, torch.as_tensor(arr.blen[None]))
    codes = torch.as_tensor(rng.integers(0, 20, size=(500, 40))
                            .astype(np.int8))
    pi = torch.as_tensor(model.pi)
    ct = rng.random((1, 40)).astype(np.float32)
    ll, g = emulate(codes, arr.children[None], pm, pi, ct, R=1, cap_f=8,
                    cap_u=8, n_chunks=1)
    assert float(ll.max()) < -1500
    orig = pruning.tip_partials
    try:  # the plain gradient in float64
        pruning.tip_partials = lambda c, p: orig(c, p).double()
        want = pruning.site_ll_grad_reference(
            codes, torch.as_tensor(arr.children[None]), pm.double(),
            pi.double(), torch.as_tensor(ct).double())
    finally:
        pruning.tip_partials = orig
    _close_norm(g, want, BWD_RTOL)
