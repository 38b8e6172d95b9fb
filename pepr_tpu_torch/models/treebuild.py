"""ML tree inference: NJ start + gradient branch lengths + batched NNI
and SPR (PyTorch port of `pepr_tpu/models/treebuild.py`).

Kimura-corrected protein distances give an NJ starting topology; branch
lengths are fitted by Adam on softplus-parameterized lengths through the
differentiable pruning kernels; hill-climbing NNI rounds score every
candidate topology of a round in one batched kernel call, and a batched
SPR sweep tries to escape when NNI converges.

Beside ML: the plain NJ tree (`nj_tree`), the Fitch parsimony search
(`parsimony_tree`, with ML branch lengths for `parsimony_bl`), matrix
evaluation (`evaluate_substitution_models`), and `ml_tree`'s constraint
tree and candidate cap.  The move generators are numpy and copied from
the JAX package.  `ml_tree` saves its search state in a checkpoint
store and stops at a deadline as the JAX package's does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pepr_tpu_torch.alphabet import N_AA
from pepr_tpu_torch.data.protein_models import model_names
from pepr_tpu_torch.device import resolve_device
from pepr_tpu_torch.ops.likelihood import (TreeArrays, WagModel,
                                           arrays_to_tree, loglik,
                                           loglik_weighted, model_tensors,
                                           tree_to_arrays)
from pepr_tpu_torch.ops.parsimony import fitch_score_topologies
from pepr_tpu_torch.pipeline.checkpoint import Incomplete
from pepr_tpu_torch.tree.basic import Tree
from pepr_tpu_torch.tree.bipartition import (bipartitions, canonical,
                                             compatible, node_leafsets,
                                             taxon_index)
from pepr_tpu_torch.tree.nj import neighbor_joining

# Adam on softplus-parameterized branch lengths, optax.adam(0.03)
# defaults: b1 0.9, b2 0.999, eps 1e-8, eps_root 0.  torch.optim.Adam
# applies the same update, theta -= lr * mhat / (sqrt(vhat) + eps).
ADAM_LR = 0.03
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
# Candidate topologies scored per kernel call (bounds the batch's
# transition matrices and output; the kernel's scratch is per block).
SCORE_BATCH = 512
# Candidate topologies per Fitch call: each holds (nodes, L) int32 state
# sets, 27 MB at 53 taxa and 64,433 columns.
FITCH_BATCH = 64


# -- distances -----------------------------------------------------------------

def _pair_counts(codes: torch.Tensor, w: torch.Tensor):
    """Weighted pairwise (valid-overlap, same-residue) count matrices as
    one-hot matmuls in float32 (exact for integer counts below 2^24)."""
    vf = (codes < N_AA).to(torch.float32)
    overlap = (vf * w[None, :]) @ vf.T
    same = torch.zeros_like(overlap)
    for a in range(N_AA):
        xa = (codes == a).to(torch.float32)
        same = same + (xa * w[None, :]) @ xa.T
    return overlap, same


def protein_distances(mat: np.ndarray, site_weights: np.ndarray | None = None,
                      max_dist: float = 5.0, device=None) -> np.ndarray:
    """Kimura-corrected pairwise distances d = -ln(1 - p - p^2/5) over
    shared non-gap columns; the O(n^2 L) counting runs on the device."""
    dev = resolve_device(device)
    n, L = mat.shape
    w = np.ones(L, np.float32) if site_weights is None else \
        np.asarray(site_weights, np.float32)
    overlap, same = _pair_counts(
        torch.as_tensor(np.asarray(mat, np.int8), device=dev),
        torch.as_tensor(w, device=dev))
    overlap = overlap.cpu().numpy().astype(np.float64)
    same = same.cpu().numpy().astype(np.float64)
    p = np.where(overlap > 0,
                 (overlap - same) / np.maximum(overlap, 1e-9), 0.75)
    arg = 1.0 - p - 0.2 * p * p
    d = np.where(arg <= 1e-6, max_dist,
                 np.minimum(-np.log(np.maximum(arg, 1e-12)), max_dist))
    np.fill_diagonal(d, 0.0)
    return d


def nj_start_tree(mat: np.ndarray, taxa: list[str],
                  site_weights: np.ndarray | None = None,
                  device=None) -> Tree:
    d = protein_distances(mat, site_weights, device=device)
    return neighbor_joining(d, taxa)


# -- branch length optimization -------------------------------------------------

def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _inv_softplus(y):
    y = np.maximum(y, 1e-6)
    return np.where(y > 20, y, np.log(np.expm1(y)))


def adam_blopt(codes: torch.Tensor, children: torch.Tensor,
               theta0: torch.Tensor, margs, weights: torch.Tensor,
               steps: int, reduce_grad=None):
    """`steps` Adam steps on the (summed) negative weighted LL of one
    tree (theta (V,)) or a batch (theta (B, V), each tree with its own
    children and weights).  `reduce_grad(grad)`, if given, sums the
    gradient in place over the ranks that hold the other columns before
    each update.  Returns (theta, nll of the last step, taken before its
    update) — the value `optax` scans report."""
    theta = theta0.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([theta], lr=ADAM_LR, betas=ADAM_BETAS,
                           eps=ADAM_EPS)
    nll = None
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        nll = -loglik_weighted(codes, children, _softplus(theta), *margs,
                               weights)
        nll.sum().backward()
        if reduce_grad is not None:
            reduce_grad(theta.grad)
        opt.step()
    return theta.detach(), (None if nll is None else nll.detach())


def optimize_branch_lengths(codes: np.ndarray, arr: TreeArrays,
                            model: WagModel,
                            site_weights: np.ndarray | None = None,
                            steps: int = 200,
                            device=None) -> tuple[np.ndarray, float]:
    """Maximize LL over all branch lengths jointly; returns (blen, ll)
    with ll the LL of the last step (before its update)."""
    dev = resolve_device(device)
    L = codes.shape[1]
    w = np.ones(L, np.float32) if site_weights is None else \
        np.asarray(site_weights, np.float32)
    theta0 = torch.as_tensor(
        _inv_softplus(np.asarray(arr.blen, np.float64)).astype(np.float32),
        device=dev)
    theta, nll = adam_blopt(
        torch.as_tensor(np.asarray(codes, np.int8), device=dev),
        torch.as_tensor(np.asarray(arr.children, np.int32), device=dev),
        theta0, model_tensors(model, dev), torch.as_tensor(w, device=dev),
        steps)
    return (_softplus(theta).cpu().numpy().astype(np.float32),
            -float(nll))


# -- NNI / SPR moves (numpy, as in the JAX package) ------------------------------

@dataclass
class _Edge:
    node: int  # child internal node (kernel id)
    parent: int  # parent internal node (kernel id)


def _internal_edges(children: np.ndarray, n_leaves: int) -> list[_Edge]:
    out = []
    n_int = children.shape[0]
    for k in range(n_int):
        for c in children[k]:
            if c >= n_leaves:
                out.append(_Edge(int(c), n_leaves + k))
    return out


def _apply_swaps(children: np.ndarray, n_leaves: int,
                 moves: list[tuple[int, int, int, int]]) -> np.ndarray:
    """Apply NNI swap moves (k_c, k_p, kid, z) to a children array.
    Moves touching disjoint (c, p) node pairs commute, so a round can
    accept several at once."""
    new = children.copy()
    for k_c, k_p, kid, z in moves:
        row_c = list(new[k_c])
        row_c[row_c.index(kid)] = z
        new[k_c] = row_c
        row_p = list(new[k_p])
        row_p[row_p.index(z)] = kid
        new[k_p] = row_p
    return new


def _nni_moves(children: np.ndarray,
               n_leaves: int) -> list[tuple[int, int, int, int]]:
    """All NNI rearrangements as swap moves (k_c, k_p, kid, z): for each
    internal edge (p -> c), swap one child of c with one sibling of c
    under p (every sibling, so both alternatives at a root
    trifurcation)."""
    moves = []
    for edge in _internal_edges(children, n_leaves):
        k_c = edge.node - n_leaves
        k_p = edge.parent - n_leaves
        c_kids = [x for x in children[k_c] if x >= 0]
        p_kids = [x for x in children[k_p] if x >= 0 and x != edge.node]
        if len(c_kids) < 2 or not p_kids:
            continue
        for z in p_kids:
            for kid in c_kids[:2]:
                moves.append((k_c, k_p, int(kid), int(z)))
    return moves


def _nni_candidates(children: np.ndarray, n_leaves: int) -> list[np.ndarray]:
    """Candidate children arrays for every NNI move."""
    return [_apply_swaps(children, n_leaves, [m])
            for m in _nni_moves(children, n_leaves)]


def _spr_candidates(children: np.ndarray, n_leaves: int
                    ) -> list[np.ndarray]:
    """Batched SPR neighborhood: prune the subtree at s (whose parent p
    is a binary non-root node, so p can be contracted and its id reused
    as the regraft node) and regraft onto every edge (x -> y) outside
    the pruned subtree.  Returns candidate children arrays (NOT
    postorder-fixed)."""
    n_int = children.shape[0]
    root = n_leaves + n_int - 1
    kids = {n_leaves + k: [int(c) for c in children[k] if c >= 0]
            for k in range(n_int)}
    parent: dict[int, int] = {c: p for p, cs in kids.items() for c in cs}

    desc: dict[int, set] = {}

    def get_desc(v: int) -> set:
        got = desc.get(v)
        if got is None:
            got = {v}
            for c in kids.get(v, []):
                got |= get_desc(c)
            desc[v] = got
        return got

    def to_array(nk: dict[int, list[int]]) -> np.ndarray:
        out = np.full_like(children, -1)
        for node, cs in nk.items():
            for ci, c in enumerate(cs):
                out[node - n_leaves, ci] = c
        return out

    cands: list[np.ndarray] = []
    for s in range(root):
        p = parent.get(s)
        if p is None or p == root or len(kids[p]) != 2:
            continue
        o = [c for c in kids[p] if c != s][0]
        q = parent.get(p)
        if q is None:
            continue
        sub = get_desc(s)
        for y, x in parent.items():
            if y in sub or y == p or y == o or x == p or x in sub:
                continue
            if x == q and y == o:
                continue  # regrafting where it came from = no-op
            nk = {k: list(v) for k, v in kids.items()}
            nk[q][nk[q].index(p)] = o  # contract p out
            del nk[p]
            nk[x] = list(nk[x])
            nk[x][nk[x].index(y)] = p  # splice p into edge (x -> y)
            nk[p] = [s, y]
            cands.append(to_array(nk))
    return cands


def _postorder_perm(children: np.ndarray, n_leaves: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Renumber internal nodes so children always precede parents.
    Returns (new_children, perm) where perm[old_id] = new_id over ALL
    node ids (identity on leaves)."""
    n_int = children.shape[0]
    kids_of = {n_leaves + k: [int(c) for c in children[k] if c >= 0]
               for k in range(n_int)}
    root = n_leaves + n_int - 1
    order: list[int] = []
    stack = [root]
    while stack:
        node = stack.pop()
        order.append(node)
        if node >= n_leaves:
            stack.extend(kids_of[node])
    order = [n for n in order[::-1] if n >= n_leaves]
    perm = np.arange(n_leaves + n_int, dtype=np.int64)
    for i, old in enumerate(order):
        perm[old] = n_leaves + i
    new_children = np.full_like(children, -1)
    for old in order:
        for ci, c in enumerate(kids_of[old]):
            new_children[perm[old] - n_leaves, ci] = perm[c]
    return new_children, perm


def _postorder_fix(children: np.ndarray, n_leaves: int) -> np.ndarray:
    return _postorder_perm(children, n_leaves)[0]


def _nni_candidate(children: np.ndarray, blen: np.ndarray, n_leaves: int,
                   moves: list[tuple[int, int, int, int]]
                   ) -> tuple[np.ndarray, np.ndarray]:
    """One NNI candidate: apply `moves`, restore postorder, and carry
    branch lengths through the id permutation (the swap target's edge
    gets the fresh-edge default)."""
    swapped = _apply_swaps(children, n_leaves, moves)
    fixed, perm = _postorder_perm(swapped, n_leaves)
    new_blen = blen.copy()
    new_blen[perm] = blen
    for k_c, _, _, _ in moves:
        new_blen[perm[n_leaves + k_c]] = 0.05  # fresh edge
    return fixed, new_blen


def _remap_blen(children_old, children_new, blen, n_leaves):
    """Carry branch lengths to a rearranged tree by matching descendant
    leaf sets (int bitmasks); unmatched edges get 0.05."""

    def leafsets(children):
        sets: dict[int, int] = {}
        for k in range(children.shape[0]):
            m = 0
            for c in children[k]:
                if c < 0:
                    continue
                m |= sets[int(c)] if c >= n_leaves else (1 << int(c))
            sets[n_leaves + k] = m
        return sets

    old_sets = {v: k for k, v in leafsets(children_old).items()}
    new_sets = leafsets(children_new)
    blen_new = blen.copy()
    for node, m in new_sets.items():
        old = old_sets.get(m)
        if old is not None:
            blen_new[node] = blen[old]
        else:
            blen_new[node] = 0.05  # fresh edge after the move
    return blen_new


def _children_bipartitions(children: np.ndarray, n_leaves: int,
                           full: int) -> set[int]:
    """Canonical internal-edge bipartitions of a kernel children array."""
    n_int = children.shape[0]
    masks: dict[int, int] = {}
    out: set[int] = set()
    for k in range(n_int):
        m = 0
        for c in children[k]:
            if c < 0:
                continue
            m |= masks[int(c)] if c >= n_leaves else (1 << int(c))
        masks[n_leaves + k] = m
        size = bin(m).count("1")
        if 1 < size < n_leaves - 1 and k < n_int - 1:
            out.add(canonical(m, full))
    return out


def _violates_constraint(children: np.ndarray, n_leaves: int,
                         constraint_bips: set[int], full: int) -> bool:
    for b in _children_bipartitions(children, n_leaves, full):
        for c in constraint_bips:
            if not compatible(b, c, full):
                return True
    return False


def fasttree_constraint_matrix(tree: Tree, taxa: list[str]) -> str:
    """Presence/absence constraint matrix from a tree, FastTree's
    constraint-file format (FastTreeRunner.getFastTreeConstraintsForTree,
    FastTreeRunner.java:243-273): one fasta row per taxon (sorted), one
    0/1 column per tree node marking descendant membership."""
    names = sorted(taxa)
    idx = taxon_index(names)
    masks = node_leafsets(tree, idx)
    lines = []
    for t in names:
        bit = 1 << idx[t]
        row = "".join("1" if m & bit else "0" for m in masks)
        lines.append(f">{t}\n{row}")
    return "\n".join(lines) + "\n"


# -- batched scoring -----------------------------------------------------------

def _score_topologies(codes: torch.Tensor, children_batch, blen_batch,
                      margs, weights: torch.Tensor) -> np.ndarray:
    """Weighted LL of each candidate topology (children, blen) in
    batched kernel calls; `weights` is (L,) shared or (B, L) per
    candidate (the JAX package's `_score_topologies[_w]`)."""
    dev = codes.device
    out = []
    with torch.no_grad():
        for c0 in range(0, len(children_batch), SCORE_BATCH):
            ch = torch.as_tensor(
                np.asarray(children_batch[c0:c0 + SCORE_BATCH], np.int32),
                device=dev)
            bl = torch.as_tensor(
                np.asarray(blen_batch[c0:c0 + SCORE_BATCH], np.float32),
                device=dev)
            w = weights if weights.dim() == 1 else \
                weights[c0:c0 + SCORE_BATCH]
            out.append(loglik_weighted(codes, ch, bl, *margs, w).cpu())
    return torch.cat(out).numpy() if out else np.zeros(0)


def ml_tree(mat: np.ndarray, taxa: list[str], model: WagModel | None = None,
            *, site_weights: np.ndarray | None = None,
            start: Tree | None = None, nni_rounds: int = 8,
            bl_steps: int = 150, bl_refine_steps: int = 60,
            spr_rounds: int = 2, constraint: Tree | None = None,
            max_candidates: int | None = None,
            store=None, deadline=None, ckpt_key: str | None = None,
            device=None) -> tuple[Tree, float]:
    """Full ML pipeline: NJ start -> BL opt -> NNI hill climbing with
    batched SPR escapes.  Each NNI round scores the full neighborhood
    (truncated to its first `max_candidates` moves if that is set, with
    a log line) and accepts every improving move whose touched nodes are
    disjoint from better moves already accepted; when NNI converges a
    batched SPR sweep tries to escape, and an accepted SPR re-enters NNI.

    With `constraint` (FastTreeRunner.java:243-273's constraint-file
    role), rearrangements introducing a bipartition incompatible with
    the constraint tree are rejected.

    With `store` + `ckpt_key` the search state (children, branch
    lengths, LL, rounds done, SPR sweeps left) is saved after the first
    branch-length fit and after every refit, the points where the
    search restarts Adam from host state, so a resumed search is the
    uninterrupted one; `deadline.near(90.0)` is polled before each NNI
    round and SPR sweep and raises Incomplete.

    Returns (tree with optimized branch lengths, final log-likelihood).
    """
    import logging
    log = logging.getLogger("pepr_tpu_torch")

    dev = resolve_device(device)
    if model is None:
        model = WagModel.create()
    if start is None:
        start = nj_start_tree(mat, taxa, site_weights, device=dev)
    arr = tree_to_arrays(start, taxa)
    codes = np.asarray(mat, np.int8)
    n_leaves = len(taxa)
    L = codes.shape[1]
    w = np.ones(L, np.float32) if site_weights is None else \
        np.asarray(site_weights, np.float32)

    use_ckpt = store is not None and ckpt_key is not None
    state = store.load(ckpt_key) if use_ckpt and store.has(ckpt_key) \
        else None
    if state is None:
        blen, ll = optimize_branch_lengths(codes, arr, model,
                                           site_weights=w, steps=bl_steps,
                                           device=dev)
        arr.blen[:] = blen
        children = arr.children.copy()
        rounds_done, spr_left = 0, spr_rounds
    else:
        children, blen, ll, rounds_done, spr_left = state
        arr = TreeArrays(children, blen, arr.node_of_tree_node, arr.taxa)
        log.info("ml_tree: resumed at round %d (LL %.3f)", rounds_done, ll)

    def save():
        if use_ckpt:
            store.save(ckpt_key, (children, arr.blen.copy(), ll,
                                  rounds_done, spr_left))

    if state is None:
        save()

    margs = model_tensors(model, dev)
    codes_d = torch.as_tensor(codes, device=dev)
    w_d = torch.as_tensor(w, device=dev)

    constraint_bips: set[int] | None = None
    full_mask = (1 << n_leaves) - 1
    if constraint is not None:
        constraint_bips = set(bipartitions(constraint,
                                           taxon_index(list(taxa))))
        if _violates_constraint(children, n_leaves, constraint_bips,
                                full_mask):
            log.info("ml_tree: starting topology violates the "
                     "constraint tree; search may not recover")

    def _allowed(cand: np.ndarray) -> bool:
        return constraint_bips is None or not _violates_constraint(
            cand, n_leaves, constraint_bips, full_mask)

    def reopt(new_children, new_blen, steps):
        nonlocal children, arr, ll
        children = new_children
        arr = TreeArrays(children, new_blen, arr.node_of_tree_node,
                         arr.taxa)
        b, new_ll = optimize_branch_lengths(codes, arr, model,
                                            site_weights=w, steps=steps,
                                            device=dev)
        arr.blen[:] = b
        ll = new_ll
        save()  # every refit is a new state

    while rounds_done < nni_rounds:
        if deadline is not None and deadline.near(90.0):
            raise Incomplete(f"full-tree NNI round {rounds_done}")
        rounds_done += 1
        moves = _nni_moves(children, n_leaves)
        if max_candidates is not None and len(moves) > max_candidates:
            log.info("ml_tree: truncating NNI neighborhood %d -> %d "
                     "(max_candidates)", len(moves), max_candidates)
            moves = moves[:max_candidates]
        if not moves:
            break
        cands = [_nni_candidate(children, arr.blen, n_leaves, [m])
                 for m in moves]
        fixed = [c for c, _ in cands]
        blens = [b for _, b in cands]
        if constraint_bips is not None:
            keep = [i for i, f in enumerate(fixed) if _allowed(f)]
            moves = [moves[i] for i in keep]
            fixed = [fixed[i] for i in keep]
            blens = [blens[i] for i in keep]
            if not moves:
                break
        scores = _score_topologies(codes_d, fixed, blens, margs, w_d)
        improving = np.nonzero(scores > ll + 1e-4)[0]
        log.info("ml_tree: NNI round %d scored %d candidates, %d improving",
                 rounds_done, len(moves), len(improving))
        if len(improving) == 0:
            # NNI converged; try a batched SPR escape
            if spr_left <= 0:
                break
            if deadline is not None and deadline.near(90.0):
                # the store holds the state this round started from: a
                # resumed search scores its NNI neighbourhood again (no
                # move, as here) and then sweeps
                raise Incomplete(
                    f"full-tree SPR sweep {spr_rounds - spr_left}")
            spr_left -= 1
            spr = _spr_candidates(children, n_leaves)
            if constraint_bips is not None:
                spr = [c for c in spr
                       if _allowed(_postorder_fix(c, n_leaves))]
            if not spr:
                break
            spr_fixed = [_postorder_fix(c, n_leaves) for c in spr]
            spr_blens = [_remap_blen(children, f, arr.blen, n_leaves)
                         for f in spr_fixed]
            s_scores = _score_topologies(codes_d, spr_fixed, spr_blens,
                                         margs, w_d)
            sbest = int(np.argmax(s_scores))
            log.info("ml_tree: SPR sweep scored %d candidates, best %+.3f LL",
                     len(spr), s_scores[sbest] - ll)
            if s_scores[sbest] <= ll + 1e-4:
                break
            log.info("ml_tree: SPR accepted (+%.3f LL, %d candidates)",
                     s_scores[sbest] - ll, len(spr))
            reopt(spr_fixed[sbest], spr_blens[sbest], bl_refine_steps)
            continue
        # accept all improving, non-conflicting moves (greedy by gain)
        taken: list[tuple[int, int, int, int]] = []
        touched: set[int] = set()
        for idx in improving[np.argsort(-scores[improving])]:
            k_c, k_p, kid, z = moves[int(idx)]
            nodes = {k_c, k_p}
            if nodes & touched:
                continue
            touched |= nodes
            taken.append(moves[int(idx)])
        prev_children, prev_blen, prev_ll = children, arr.blen.copy(), ll
        new_children, new_blen = _nni_candidate(children, arr.blen,
                                                n_leaves, taken)
        if len(taken) > 1 and not _allowed(new_children):
            # combined moves (each allowed alone) can still violate the
            # constraint together: take the best single move
            best = int(improving[np.argmax(scores[improving])])
            new_children, new_blen = fixed[best], blens[best]
        reopt(new_children, new_blen, bl_refine_steps)
        if len(taken) > 1 and ll < prev_ll:
            # combined moves (scored individually) regressed — fall back
            # to applying only the best single move
            children, ll = prev_children, prev_ll
            arr = TreeArrays(prev_children, prev_blen,
                             arr.node_of_tree_node, arr.taxa)
            best = int(improving[np.argmax(scores[improving])])
            reopt(fixed[best], blens[best], bl_refine_steps)
    else:
        log.info("ml_tree: NNI round budget (%d) exhausted before "
                 "convergence", nni_rounds)

    final = arrays_to_tree(TreeArrays(children, arr.blen,
                                      arr.node_of_tree_node, taxa))
    return final, ll


def estimate_gamma_alpha(mat: np.ndarray, taxa: list[str], tree: Tree, *,
                         grid=(0.3, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0),
                         site_weights: np.ndarray | None = None,
                         refine_iters: int = 2, device=None) -> float:
    """ML estimate of the Gamma shape on a fixed topology: coarse grid
    plus golden-section refinement of the LL in alpha."""
    dev = resolve_device(device)
    arr = tree_to_arrays(tree, taxa)

    def ll(alpha: float) -> float:
        return loglik(mat, arr.children, arr.blen,
                      WagModel.create(alpha=alpha),
                      site_weights=site_weights, device=dev)

    scores = [ll(a) for a in grid]
    best = int(np.argmax(scores))
    lo = grid[max(best - 1, 0)]
    hi = grid[min(best + 1, len(grid) - 1)]
    phi = (np.sqrt(5) - 1) / 2
    a, b = lo, hi
    x1 = b - phi * (b - a)
    x2 = a + phi * (b - a)
    f1, f2 = ll(x1), ll(x2)
    for _ in range(refine_iters * 3):
        if f1 < f2:
            a, x1, f1 = x1, x2, f2
            x2 = a + phi * (b - a)
            f2 = ll(x2)
        else:
            b, x2, f2 = x2, x1, f1
            x1 = b - phi * (b - a)
            f1 = ll(x1)
    return float((a + b) / 2)


def nj_tree(mat: np.ndarray, taxa: list[str],
            site_weights: np.ndarray | None = None, device=None) -> Tree:
    """Plain NJ tree (the reference's `-nj` fast path,
    PhylogenomicPipeline2.java:1279-1293)."""
    return nj_start_tree(mat, taxa, site_weights, device=device)


def empirical_aa_freqs(mat: np.ndarray) -> np.ndarray:
    """Observed residue frequencies (the RAxML '...F' convention)."""
    counts = np.bincount(
        np.asarray(mat[mat < N_AA], np.int64), minlength=N_AA
    ).astype(np.float64)
    counts += 1.0
    return counts / counts.sum()


def evaluate_substitution_models(mat: np.ndarray, taxa: list[str],
                                 names: list[str] | None = None, *,
                                 alpha: float = 1.0, bl_steps: int = 120,
                                 device=None
                                 ) -> tuple[str, dict[str, float]]:
    """Matrix evaluation (PhylogenomicPipeline2.java:252-295,
    1390-1451): build one parsimony tree, then score it under every
    candidate substitution model (branch lengths re-optimized per
    model, the `-f e` role) and return (best model name, scores)."""
    import logging

    log = logging.getLogger("pepr_tpu_torch")
    dev = resolve_device(device)
    if names is None:
        names = model_names()
    tree, _ = parsimony_tree(mat, taxa, nni_rounds=4, device=dev)
    arr = tree_to_arrays(tree, taxa)
    emp = empirical_aa_freqs(mat)
    scores: dict[str, float] = {}
    for name in names:
        model = WagModel.named(name, alpha=alpha, empirical_freqs=emp)
        _, ll = optimize_branch_lengths(np.asarray(mat, np.int8), arr,
                                        model, steps=bl_steps, device=dev)
        scores[name] = ll
        log.info("matrix evaluation: %s LL=%.2f", name, ll)
    best = max(scores, key=scores.get)
    log.info("matrix evaluation: preferred matrix is %s", best)
    return best, scores


def parsimony_tree(mat: np.ndarray, taxa: list[str], *,
                   site_weights: np.ndarray | None = None,
                   branch_lengths: bool = False,
                   model: WagModel | None = None,
                   nni_rounds: int = 8, bl_steps: int = 150,
                   max_candidates: int | None = None,
                   device=None) -> tuple[Tree, float]:
    """Parsimony topology search (the reference's `parsimony` method,
    RAxMLRunner.java:134-140): NJ start + NNI hill climbing under the
    Fitch score, each round's candidates scored in batches of
    FITCH_BATCH.  With `branch_lengths`, ML branch lengths are fitted on
    the final topology (the `parsimony_bl` two-phase,
    RAxMLRunner.java:215-280, gradient opt instead of `-f e`).  Without
    it the tree keeps the NJ start's lengths by node id, as the JAX
    package's does.

    Returns (tree, parsimony score)."""
    import logging

    log = logging.getLogger("pepr_tpu_torch")
    dev = resolve_device(device)
    start = nj_start_tree(mat, taxa, site_weights, device=dev)
    arr = tree_to_arrays(start, taxa)
    codes = np.asarray(mat, np.int8)
    n_leaves = len(taxa)
    L = codes.shape[1]
    w = np.ones(L, np.float32) if site_weights is None else \
        np.asarray(site_weights, np.float32)
    codes_d = torch.as_tensor(codes, device=dev)
    w_d = torch.as_tensor(w, device=dev)

    def score(cands: list[np.ndarray]) -> np.ndarray:
        out = []
        with torch.no_grad():
            for c0 in range(0, len(cands), FITCH_BATCH):
                ch = torch.as_tensor(np.stack(cands[c0:c0 + FITCH_BATCH]),
                                     device=dev)
                out.append(fitch_score_topologies(codes_d, ch, w_d).cpu())
        return torch.cat(out).numpy()

    children = arr.children.copy()
    best_score = float(score([children])[0])
    rounds = 0
    for _ in range(nni_rounds):
        cands = _nni_candidates(children, n_leaves)
        if not cands:
            break
        cands = [_postorder_fix(c, n_leaves)
                 for c in cands[:max_candidates]]
        scores = score(cands)
        rounds += 1
        best = int(np.argmin(scores))
        if scores[best] >= best_score:
            break
        best_score = float(scores[best])
        children = cands[best]
    log.info("parsimony_tree: score %.0f after %d NNI rounds", best_score,
             rounds)

    arr = TreeArrays(children, arr.blen, arr.node_of_tree_node, taxa)
    if branch_lengths:
        if model is None:
            model = WagModel.create()
        blen, _ = optimize_branch_lengths(codes, arr, model,
                                          site_weights=w, steps=bl_steps,
                                          device=dev)
        arr.blen[:] = blen
    return arrays_to_tree(arr), best_score
