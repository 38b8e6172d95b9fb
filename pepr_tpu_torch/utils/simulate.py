"""Sequence evolution simulator (test/benchmark utility): evolves
protein sites down a tree under WAG(+Gamma), giving ground-truth
topologies for recovering-the-tree tests."""

from __future__ import annotations

import math

import numpy as np

from pepr_tpu_torch.data.wag import WAG_FREQS, wag_eigensystem
from pepr_tpu_torch.ops.gamma import discrete_gamma_rates
from pepr_tpu_torch.tree.basic import Tree


def simulate_alignment(tree: Tree, length: int, rng,
                       alpha: float | None = None) -> tuple[np.ndarray, list[str]]:
    """Returns (codes (n_leaves, L) int8, taxa) evolved under WAG."""
    eig, u, ui = wag_eigensystem()
    if alpha is None:
        rates = np.ones(length)
    else:
        cats = discrete_gamma_rates(alpha, 4)
        rates = cats[rng.integers(0, 4, size=length)]

    root = tree.root
    states: dict[int, np.ndarray] = {
        root: rng.choice(20, size=length, p=WAG_FREQS / WAG_FREQS.sum())}
    order = tree.preorder()
    # cache P(t) per (blen) value x rate category
    for node in order:
        if node == root:
            continue
        t = tree.blen[node]
        t = 0.1 if (t is None or math.isnan(t)) else max(float(t), 1e-8)
        parent_state = states[tree.parent[node]]
        child = np.empty(length, dtype=np.int8)
        for r in np.unique(rates):
            p = u @ np.diag(np.exp(eig * t * r)) @ ui
            p = np.clip(p, 0, None)
            p /= p.sum(axis=1, keepdims=True)
            mask = rates == r
            ps = parent_state[mask]
            # vectorized categorical sampling via cdf + uniform
            cdf = np.cumsum(p[ps], axis=1)
            uvals = rng.random(len(ps))[:, None]
            child[mask] = (uvals > cdf).sum(axis=1).astype(np.int8)
        states[node] = child
    leaves = tree.leaves()
    taxa = [tree.labels[i] for i in leaves]
    codes = np.stack([states[i] for i in leaves]).astype(np.int8)
    return codes, taxa


# -- synthetic phylogenomic datasets (the port's additions) ---------------------

def random_tree(names: list[str], rng, scale: float = 0.06) -> Tree:
    """Random binary tree over `names`, joining random pairs, with
    branch lengths 0.01 + Exp(scale) (the generator of
    conformance/gen50.py)."""
    from pepr_tpu_torch.tree.basic import parse_newick
    nodes = [f"{n}:{rng.exponential(scale) + 0.01:.4f}" for n in names]
    while len(nodes) > 2:
        i, j = rng.choice(len(nodes), size=2, replace=False)
        rest = [n for k, n in enumerate(nodes) if k not in (i, j)]
        rest.append(f"({nodes[i]},{nodes[j]}):"
                    f"{rng.exponential(scale) + 0.01:.4f}")
        nodes = rest
    return parse_newick(f"({nodes[0]},{nodes[1]});")


def simulate_families(tree: Tree, lengths, rng, alpha: float | None = 0.5,
                      absent: float = 0.1, min_taxa: int = 4):
    """Gene families evolved down `tree` under WAG(+Gamma): one
    (name, taxa, codes) triple per entry of `lengths`, each family
    missing a random ~`absent` share of the taxa (at least `min_taxa`
    stay), as homolog groups absent from some genomes are."""
    fams = []
    for g, length in enumerate(lengths):
        codes, taxa = simulate_alignment(tree, int(length), rng, alpha=alpha)
        keep = rng.random(len(taxa)) >= absent
        if keep.sum() < min_taxa:
            keep[rng.choice(len(taxa), size=min_taxa, replace=False)] = True
        idx = np.nonzero(keep)[0]
        fams.append((f"fam{g:04d}", [taxa[i] for i in idx], codes[idx]))
    return fams
