"""Sequence evolution simulator (test/benchmark utility): evolves
protein sites down a tree under WAG(+Gamma), giving ground-truth
topologies for recovering-the-tree tests."""

from __future__ import annotations

import math

import numpy as np

from pepr_tpu_torch.data.wag import WAG_FREQS, wag_eigensystem
from pepr_tpu_torch.ops.gamma import discrete_gamma_rates
from pepr_tpu_torch.tree.basic import Tree, parse_newick, to_newick


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


def simulate_genomes(rng, n_ingroup: int = 11, n_pool: int = 1,
                     n_families: int = 1300, n_random: int = 100,
                     median_len: float = 306.0, sigma: float = 0.5,
                     min_len: int = 50, max_len: int = 2000,
                     long_lengths=(2100, 2600), n_long: int = 3,
                     p_ingroup: float = 0.8, p_pool: float = 0.85,
                     ingroup_tree: Tree | None = None):
    """Protein genomes for stage 1, in the manner of the JAX package's
    conformance/gen50.py: a random ingroup tree (branch lengths
    0.01 + Exp(0.06)) with the outgroup pool on a 0.45 basal branch; per
    family a WAG-evolved protein under a lognormal(0, 0.35) rate
    multiplier, present in each ingroup genome with probability
    `p_ingroup` and in each pool genome with `p_pool` (in at least 2
    genomes); plus `n_random` unrelated random proteins per genome.
    Family lengths are lognormal (median `median_len`, shape `sigma`)
    clipped to [min_len, max_len], and `n_long` families are drawn
    uniformly from `long_lengths`.  `ingroup_tree`, if given, replaces
    the random ingroup tree; its leaves are the ingroup taxa
    (`Synthica_specNN_strain_X`, NN from 00).

    Titles are `famNNNN_<taxon> [<Genus species strain>]` (random
    proteins `rndNNNN_...`), with a distinct genus + species per genome.
    Returns (ingroup, pool) lists of SequenceSet and the generating
    tree (leaf labels are the taxa as `taxon_from_title` reads them)."""
    from pepr_tpu_torch.io.fasta import SequenceSet

    ingroup = [f"Synthica spec{i:02d} strain X" for i in range(n_ingroup)]
    pool = [f"Outgroupia outg{i} strain Y" for i in range(n_pool)]
    label = {n: n.replace(" ", "_") for n in ingroup + pool}
    if ingroup_tree is None:
        ingroup_tree = random_tree([label[n] for n in ingroup], rng)
    elif sorted(ingroup_tree.leaf_labels()) != sorted(label[n]
                                                      for n in ingroup):
        raise ValueError("ingroup_tree's leaves must be the ingroup taxa")
    in_nwk = to_newick(ingroup_tree)[:-1]
    if n_pool == 1:
        og_nwk = label[pool[0]]
    else:
        og_nwk = to_newick(random_tree([label[n] for n in pool], rng,
                                       scale=0.10))[:-1]
    tree = parse_newick(f"({in_nwk}:0.05,{og_nwk}:0.45);")

    lengths = np.clip(np.rint(median_len * np.exp(
        rng.normal(0.0, sigma, size=n_families))), min_len, max_len)
    lengths[rng.choice(n_families, size=n_long, replace=False)] = \
        rng.integers(long_lengths[0], long_lengths[1] + 1, size=n_long)
    present_p = {label[n]: p_ingroup for n in ingroup}
    present_p.update({label[n]: p_pool for n in pool})
    titles = {n: [] for n in ingroup + pool}
    seqs = {n: [] for n in ingroup + pool}
    by_label = {label[n]: n for n in ingroup + pool}
    freqs = WAG_FREQS / WAG_FREQS.sum()
    for f, length in enumerate(lengths.astype(int)):
        scaled = tree.copy()
        scaled.blen = scaled.blen * float(np.exp(rng.normal(0.0, 0.35)))
        codes, taxa = simulate_alignment(scaled, length, rng)
        keep = rng.random(len(taxa)) < np.array([present_p[t] for t in taxa])
        if keep.sum() < 2:
            keep[rng.choice(len(taxa), size=2, replace=False)] = True
        for row, t, k in zip(codes, taxa, keep):
            if k:
                name = by_label[t]
                titles[name].append(f"fam{f:04d}_{t} [{name}]")
                seqs[name].append(row.astype(np.int8))
    for name in ingroup + pool:
        for r in range(n_random):
            length = int(np.clip(np.rint(median_len * np.exp(
                rng.normal(0.0, sigma))), min_len, max_len))
            titles[name].append(f"rnd{r:04d}_{label[name]} [{name}]")
            seqs[name].append(rng.choice(20, size=length, p=freqs)
                              .astype(np.int8))
    sets = {n: SequenceSet(label[n], titles[n], seqs[n])
            for n in ingroup + pool}
    return [sets[n] for n in ingroup], [sets[n] for n in pool], tree
