"""Felsenstein pruning log-likelihood under WAG+Gamma, any registered
protein model or nucleotide GTR (PyTorch port of
`pepr_tpu/ops/likelihood.py`).

Per-edge transition matrices P(r_c t) = U exp(L r_c t) U^-1 come from
the model's eigensystem by a plain einsum (autograd carries branch-length
gradients through it); the per-site log-likelihood of a batch of trees
goes through `ops.pruning.site_ll` — the hand-written forward and
gradient kernels on the card, their plain versions on the CPU.

Precision: float32 throughout, with TF32 switched off for matmuls and
cuDNN whenever an entry point resolves a CUDA device
(`device.resolve_device`).  The JAX package records (its `HIGHEST`
precision note, commit 0da04fc) that anything below full float32 left
real-data branch-length gradients NaN.

Node convention (as in the JAX package): ids 0..n_leaves-1 are leaves
(alignment row order); internal nodes follow in postorder, the last is
the root (up to 3 children).  `children[i, :3]` holds child ids, -1
padding.  `blen[v]` is the edge above node v (root entry ignored).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from pepr_tpu_torch.alphabet import N_AA
from pepr_tpu_torch.data.protein_models import eigensystem, resolve_model
from pepr_tpu_torch.data.wag import WAG_FREQS, wag_eigensystem
from pepr_tpu_torch.ops.gamma import discrete_gamma_rates
from pepr_tpu_torch.ops.pruning import site_ll
# (n_leaves, L) int8 -> (n_leaves, L, 20) tip partials: one-hot, ones
# over the live states (pi > 1e-6) for ambiguity codes (>= 20)
from pepr_tpu_torch.ops.pruning import tip_partials as tips_to_partials
from pepr_tpu_torch.tree.basic import Tree


@dataclass(frozen=True)
class WagModel:
    eig: np.ndarray  # (20,)
    u: np.ndarray  # (20, 20)
    u_inv: np.ndarray  # (20, 20)
    pi: np.ndarray  # (20,)
    rates: np.ndarray  # (C,)

    @classmethod
    def create(cls, alpha: float = 1.0, n_cats: int = 4) -> "WagModel":
        eig, u, u_inv = wag_eigensystem()
        return cls(eig.astype(np.float32), u.astype(np.float32),
                   u_inv.astype(np.float32), WAG_FREQS.astype(np.float32),
                   discrete_gamma_rates(alpha, n_cats).astype(np.float32))

    @classmethod
    def gtr_nt(cls, freqs: np.ndarray | None = None,
               rates: np.ndarray | None = None, alpha: float = 1.0,
               n_cats: int = 4) -> "WagModel":
        """Nucleotide GTR+Gamma riding the 20-state engine (FastTree
        `-gtr -nt` role, FastTreeRunner.java:67-77): the 4x4 GTR block
        sits in states 0-3 (ACGT), the 16 dead states get frequency
        1e-10 so tip masking keeps their partials exactly zero.

        freqs: (4,) base frequencies (default uniform).
        rates: (4, 4) symmetric exchangeabilities or a length-6 vector
        (AC, AG, AT, CG, CT, GT); default all-equal.
        """
        f4 = np.full(4, 0.25) if freqs is None \
            else np.asarray(freqs, np.float64)
        f4 = f4 / f4.sum()
        if rates is None:
            r4 = np.ones((4, 4))
        else:
            rates = np.asarray(rates, np.float64)
            if rates.shape == (6,):
                r4 = np.zeros((4, 4))
                r4[np.triu_indices(4, 1)] = rates
                r4 = r4 + r4.T
            else:
                r4 = rates
        np.fill_diagonal(r4, 0.0)
        big_r = np.zeros((N_AA, N_AA))
        big_r[:4, :4] = r4
        pi = np.full(N_AA, 1e-10)
        pi[:4] = f4 * (1.0 - 16e-10)
        eig, u, u_inv = eigensystem(big_r, pi)
        return cls(eig.astype(np.float32), u.astype(np.float32),
                   u_inv.astype(np.float32), pi.astype(np.float32),
                   discrete_gamma_rates(alpha, n_cats).astype(np.float32))

    @classmethod
    def named(cls, name: str, alpha: float = 1.0, n_cats: int = 4,
              empirical_freqs: np.ndarray | None = None) -> "WagModel":
        """Any registered substitution model (data/protein_models.py),
        '...F' variants taking the alignment's empirical frequencies —
        matrix evaluation's constructor
        (PhylogenomicPipeline2.java:1390-1451 role)."""
        rates, pi = resolve_model(name, empirical_freqs)
        eig, u, u_inv = eigensystem(rates, pi)
        return cls(eig.astype(np.float32), u.astype(np.float32),
                   u_inv.astype(np.float32), pi.astype(np.float32),
                   discrete_gamma_rates(alpha, n_cats).astype(np.float32))


def from_jax_arrays(eig, u, u_inv, pi, rates) -> WagModel:
    """The port's model from the JAX `WagModel`'s fields (as numpy
    arrays), so that both packages compute with the same parameters."""
    return WagModel(*(np.array(x, dtype=np.float32)
                      for x in (eig, u, u_inv, pi, rates)))


def model_tensors(model: WagModel, device) -> tuple[torch.Tensor, ...]:
    """(eig, u, u_inv, pi, rates) as float32 tensors on `device`."""
    return tuple(torch.as_tensor(np.asarray(x, np.float32), device=device)
                 for x in (model.eig, model.u, model.u_inv, model.pi,
                           model.rates))


def _pmats(eig, u, u_inv, rates, blen: torch.Tensor) -> torch.Tensor:
    t = blen.clamp_min(1e-9)
    ex = torch.exp(eig * rates[:, None, None] * t[..., None, :, None])
    # clamp at zero: the f32 eigen-reconstruction can produce tiny
    # negative probabilities which snowball through the per-node
    # rescaling into inf/NaN
    return torch.einsum("ab,...cvb,bd->...cvad", u, ex, u_inv).clamp_min(0.0)


def transition_matrices(model: WagModel, blen: torch.Tensor) -> torch.Tensor:
    """(C, V, 20, 20) P(r_c t_v) for blen (V,), or (B, C, V, 20, 20) for
    blen (B, V); rows = parent state."""
    eig, u, u_inv, _, rates = model_tensors(model, blen.device)
    return _pmats(eig, u, u_inv, rates, blen)


def loglik_sites(codes: torch.Tensor, children: torch.Tensor,
                 blen: torch.Tensor, eig, u, u_inv, pi,
                 rates) -> torch.Tensor:
    """Per-site log-likelihood: (L,) for one tree (children (n_int, 3),
    blen (V,)), or (B, L) for a batch (children (B, n_int, 3), blen
    (B, V)).  codes: (n_leaves, L) int8, or (B, n_leaves, L)."""
    single = children.dim() == 2
    ch = children[None] if single else children
    bl = blen[None] if single else blen
    pm = _pmats(eig, u, u_inv, rates, bl).contiguous()
    ll = site_ll(codes.contiguous(), ch.to(torch.int32).contiguous(), pm,
                 pi.contiguous())
    return ll[0] if single else ll


def loglik_weighted(codes, children, blen, eig, u, u_inv, pi, rates,
                    weights: torch.Tensor) -> torch.Tensor:
    """Total weighted log-likelihood, summed in float64: a scalar for
    one tree, (B,) for a batch (weights (L,) or (B, L))."""
    ll = loglik_sites(codes, children, blen, eig, u, u_inv, pi, rates)
    return (ll.double() * weights.double()).sum(-1)


def loglik(codes, children, blen, model: WagModel, site_weights=None,
           device=None) -> float:
    """Total (weighted) log-likelihood of one tree."""
    from pepr_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    codes_t = torch.as_tensor(np.asarray(codes, np.int8), device=dev)
    L = codes_t.shape[1]
    w = torch.ones(L, device=dev) if site_weights is None else \
        torch.as_tensor(np.asarray(site_weights, np.float32), device=dev)
    with torch.no_grad():
        total = loglik_weighted(
            codes_t, torch.as_tensor(np.asarray(children, np.int32),
                                     device=dev),
            torch.as_tensor(np.asarray(blen, np.float32), device=dev),
            *model_tensors(model, dev), w)
    return float(total)


# -- Tree <-> kernel array conversion -----------------------------------------

@dataclass
class TreeArrays:
    children: np.ndarray  # (n_int, 3) int32
    blen: np.ndarray  # (n_nodes,) float32
    node_of_tree_node: np.ndarray  # kernel id per Tree node index
    taxa: list[str]  # leaf order = alignment row order

    @property
    def n_leaves(self) -> int:
        return len(self.taxa)


def tree_to_arrays(tree: Tree, taxa: list[str],
                   default_blen: float = 0.1) -> TreeArrays:
    """Convert a Tree (binary or root-trifurcating) to kernel arrays.
    `taxa` fixes the leaf-id order (alignment rows)."""
    t_index = {t: i for i, t in enumerate(taxa)}
    n_leaves = len(taxa)
    post = [int(x) for x in tree.postorder()]
    internals = [n for n in post if not tree.is_leaf(n)]
    kid_counts = [len(tree.children[n]) for n in internals]
    if max(kid_counts) > 3:
        raise ValueError("kernel supports <= 3 children per node")
    n_int = len(internals)
    kernel_id = np.full(tree.n_nodes, -1, dtype=np.int32)
    for n in post:
        if tree.is_leaf(n):
            label = tree.labels[n]
            if label not in t_index:
                raise KeyError(f"leaf {label!r} not in taxa")
            kernel_id[n] = t_index[label]
    for k, n in enumerate(internals):
        kernel_id[n] = n_leaves + k
    children = np.full((n_int, 3), -1, dtype=np.int32)
    for k, n in enumerate(internals):
        for c, kid in enumerate(tree.children[n]):
            children[k, c] = kernel_id[kid]
    blen = np.full(n_leaves + n_int, default_blen, dtype=np.float32)
    for n in post:
        b = tree.blen[n]
        if np.isfinite(b) and b >= 0:
            blen[kernel_id[n]] = max(float(b), 1e-8)
    return TreeArrays(children, blen, kernel_id, list(taxa))


def arrays_to_tree(arr: TreeArrays, supports: np.ndarray | None = None) -> Tree:
    """Kernel arrays -> Tree (for Newick output)."""
    n_leaves = arr.n_leaves
    n_int = arr.children.shape[0]
    n_nodes = n_leaves + n_int
    parent = np.full(n_nodes, -1, dtype=np.int32)
    for k in range(n_int):
        for c in arr.children[k]:
            if c >= 0:
                parent[c] = n_leaves + k
    labels: list = [arr.taxa[i] for i in range(n_leaves)] + [None] * n_int
    blen = np.array([float(b) for b in arr.blen])
    blen_out = np.where(parent >= 0, blen, math.nan)
    sup = np.full(n_nodes, math.nan)
    if supports is not None:
        sup[n_leaves:] = supports
    return Tree(parent, labels, blen_out, sup)


__all__ = ["N_AA", "WagModel", "from_jax_arrays", "model_tensors",
           "tips_to_partials", "transition_matrices", "loglik_sites",
           "loglik_weighted", "loglik", "TreeArrays", "tree_to_arrays",
           "arrays_to_tree"]
