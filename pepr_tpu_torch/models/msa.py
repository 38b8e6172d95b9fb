"""Progressive multiple sequence alignment (muscle replacement; PyTorch
port of `pepr_tpu/models/msa.py`).

Reference behavior replaced: MultipleSequenceAligner.java:90-141 (muscle
`-fasta -stable -quiet` per homolog group).  A UPGMA guide tree over
hashed k-mer cosine distances, then postorder profile-profile merges
through the batched affine-NW wavefront (`ops/profile_align.py`).
`align_families` schedules merges across many gene families in
level-synchronous waves, so the device sees full batches of same-bucket
DP problems; every call of a wave is launched before the host walks the
first call's pointers, so the tracebacks overlap the device's DP.

Profiles stay float32 (the reference rounds them to bfloat16 for the
TPU's host link).  Not ported: `align_families_chunked`'s checkpoint
store and deadline.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

import numpy as np
import torch

from pepr_tpu_torch.alphabet import GAP, N_AA
from pepr_tpu_torch.device import resolve_device
from pepr_tpu_torch.io.fasta import SequenceSet
from pepr_tpu_torch.ops.kmer_filter import kmer_profiles
from pepr_tpu_torch.ops.profile_align import (blosum_core, nw_profile_dp,
                                              traceback)

log = logging.getLogger("pepr_tpu_torch")

MIN_BATCH = 8  # smallest padded batch of a DP call
MIN_BUCKET = 64  # smallest padded profile length of a DP call

# The progressive MSA's tally, reset with `reset_align_counts`: DP calls,
# DP steps (sum of L1 + L2 + 1), pointer bytes copied to the host, host
# seconds in tracebacks and merges.
ALIGN = {"calls": 0, "dp_steps": 0, "ptr_bytes": 0, "host_seconds": 0.0}


def reset_align_counts() -> None:
    """Zero the tally."""
    ALIGN.update(calls=0, dp_steps=0, ptr_bytes=0, host_seconds=0.0)


def upgma(dist: np.ndarray) -> list[tuple[int, int]]:
    """UPGMA merge order on a condensed distance matrix.  Returns merge
    pairs referring to cluster ids (leaves 0..n-1, new clusters n+k).
    Vectorized (whole-matrix argmin + row/column average update per
    merge)."""
    n = dist.shape[0]
    if n < 2:
        return []
    d = dist.astype(np.float64).copy()
    np.fill_diagonal(d, np.inf)
    size = np.ones(n)
    cid = np.arange(n)
    merges: list[tuple[int, int]] = []
    next_id = n
    for _ in range(n - 1):
        k = int(np.argmin(d))
        i, j = divmod(k, n)
        if i > j:
            i, j = j, i
        merges.append((int(cid[i]), int(cid[j])))
        new = (size[i] * d[i] + size[j] * d[j]) / (size[i] + size[j])
        d[i, :] = new
        d[:, i] = new
        d[i, i] = np.inf
        d[j, :] = np.inf
        d[:, j] = np.inf
        size[i] += size[j]
        cid[i] = next_id
        next_id += 1
    return merges


@dataclass
class _Cluster:
    rows: list[int]  # original sequence indices
    mat: np.ndarray  # (n_rows, L) int8 aligned codes


def _profile(mat: np.ndarray) -> np.ndarray:
    """(L, 20) frequency profile; gaps contribute zero mass (columns are
    normalized by total rows so gappy columns score low).  One bincount
    over (column, residue) in place of the reference's 20 comparisons;
    the counts, and so the profile, are the same."""
    n, L = mat.shape
    codes = mat.astype(np.int64)
    ok = codes < N_AA
    cols = np.broadcast_to(np.arange(L), mat.shape)
    counts = np.bincount(cols[ok] * N_AA + codes[ok], minlength=L * N_AA)
    prof = counts.reshape(L, N_AA).astype(np.float32)
    prof /= max(n, 1)
    return prof


def _merge(a: _Cluster, b: _Cluster, moves: list[tuple[int, int]]) -> _Cluster:
    La, Lb = a.mat.shape[1], b.mat.shape[1]
    mv = np.asarray(moves, dtype=np.int64).reshape(-1, 2)
    cols = mv.shape[0]
    na = len(a.rows)
    out = np.full((na + len(b.rows), cols), GAP, dtype=np.int8)
    ia = np.cumsum(mv[:, 0]) - 1
    ib = np.cumsum(mv[:, 1]) - 1
    ca = mv[:, 0] == 1
    cb = mv[:, 1] == 1
    out[:na, ca] = a.mat[:, ia[ca]]
    out[na:, cb] = b.mat[:, ib[cb]]
    if not (ca.sum() == La and cb.sum() == Lb):
        raise ValueError(f"bad path: {ca.sum()}/{La} {cb.sum()}/{Lb}")
    return _Cluster(a.rows + b.rows, out)


def _pad_profiles(profs: list[np.ndarray], L: int):
    """(B, L, 20) float32 profiles zero-padded to the bucket length L,
    and their (B,) true lengths (the reference pads to a multiple of 64
    and then fits to the bucket, `_fit`; the result is the same)."""
    lens = np.array([p.shape[0] for p in profs], dtype=np.int32)
    out = np.zeros((len(profs), L, N_AA), dtype=np.float32)
    for i, p in enumerate(profs):
        out[i, : p.shape[0]] = p
    return out, lens


def _to_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on `dev`; through pinned memory on the card, so the
    copy is queued behind the device's work instead of waiting for it."""
    t = torch.from_numpy(arr)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def align_families(families: list[list[np.ndarray]], *,
                   gap_open: float = 11.0, gap_extend: float = 1.0,
                   batch_size: int = 256,
                   core: np.ndarray | None = None,
                   guide_merges: list[list[tuple[int, int]]] | None = None,
                   device=None) -> list[np.ndarray]:
    """Align many families; returns (n_i, L_i) int8 matrices.

    Merges across families are executed in waves: every family exposes
    its next ready merge, all ready merges are bucketed by power-of-two
    padded profile lengths and run as batched DP calls on `device` (the
    card unless "cpu").

    `guide_merges` overrides the default k-mer-cosine UPGMA guide per
    family (refinement passes supply alignment-informed guides).
    """
    dev = resolve_device(device)
    core_t = torch.as_tensor(blosum_core() if core is None else
                             np.asarray(core, np.float32), device=dev)
    pinned = dev.type == "cuda"
    # per-family state: clusters + pending merge schedule
    states: list[dict] = []
    for fi, seqs in enumerate(families):
        n = len(seqs)
        clusters = {i: _Cluster([i], np.asarray(seqs[i],
                                                dtype=np.int8)[None, :])
                    for i in range(n)}
        if n == 1:
            states.append({"clusters": clusters, "merges": [], "next": 0})
            continue
        if guide_merges is not None:
            merges = guide_merges[fi]
        else:
            profs = kmer_profiles(seqs, dim=256)
            sims = np.clip(profs @ profs.T, 0.0, 1.0)
            dist = 1.0 - sims
            merges = upgma(dist)
        states.append({"clusters": clusters, "merges": merges, "next": 0})

    def pl(p):
        x = max(p.shape[0], 1)
        return int(max(MIN_BUCKET, 2 ** int(np.ceil(np.log2(x)))))

    while True:
        # gather ready merges: (family, merge index)
        jobs = []
        for fi, st in enumerate(states):
            k = st["next"]
            if k < len(st["merges"]):
                ci, cj = st["merges"][k]
                if ci in st["clusters"] and cj in st["clusters"]:
                    jobs.append((fi, ci, cj, st["clusters"][ci],
                                 st["clusters"][cj]))
        if not jobs:
            break
        profs1 = [_profile(j[3].mat) for j in jobs]
        profs2 = [_profile(j[4].mat) for j in jobs]

        # bucket by power-of-two padded length pair
        buckets: dict[tuple[int, int], list[int]] = {}
        for k, (pa, pb) in enumerate(zip(profs1, profs2)):
            buckets.setdefault((pl(pa), pl(pb)), []).append(k)

        # launch every call of the wave, each followed by its pointers'
        # copy to the host; then walk them in launch order
        calls = []
        for (L1, L2), idxs in sorted(buckets.items()):
            for s0 in range(0, len(idxs), batch_size):
                chunk = idxs[s0:s0 + batch_size]
                # pad the batch dim to a power of two, at least
                # MIN_BATCH: fewer shapes, so fewer CUDA graphs to
                # capture; a DP step's time hardly depends on the batch
                bpad = max(MIN_BATCH,
                           int(2 ** np.ceil(np.log2(max(len(chunk), 1)))))
                chunk = chunk + [chunk[-1]] * (bpad - len(chunk))
                p1, l1 = _pad_profiles([profs1[k] for k in chunk], L1)
                p2, l2 = _pad_profiles([profs2[k] for k in chunk], L2)
                _, ptr = nw_profile_dp(
                    _to_device(p1, dev), _to_device(p2, dev),
                    _to_device(l1, dev), _to_device(l2, dev),
                    gap_open=gap_open, gap_extend=gap_extend,
                    core_matrix=core_t)
                host = torch.empty(ptr.shape, dtype=torch.uint8,
                                   pin_memory=pinned)
                host.copy_(ptr, non_blocking=True)
                done = None
                if pinned:
                    done = torch.cuda.Event()
                    done.record()
                ALIGN["calls"] += 1
                ALIGN["dp_steps"] += L1 + L2 + 1
                ALIGN["ptr_bytes"] += host.numel()
                calls.append((chunk, l1, l2, host, done))

        for chunk, l1, l2, host, done in calls:
            if done is not None:
                done.synchronize()
            t0 = time.time()
            ptrs = host.numpy()  # (diagonal, batch, row)
            seen: set[int] = set()
            for bi, k in enumerate(chunk):
                if k in seen:  # batch padding duplicates
                    continue
                seen.add(k)
                fi, ci, cj, a, b = jobs[k]
                moves = traceback(ptrs[:, bi], int(l1[bi]), int(l2[bi]))
                st = states[fi]
                merged = _merge(a, b, moves)
                del st["clusters"][ci], st["clusters"][cj]
                new_id = len(families[fi]) + st["next"]
                st["clusters"][new_id] = merged
                st["next"] += 1
            ALIGN["host_seconds"] += time.time() - t0

    out: list[np.ndarray] = []
    for fi, st in enumerate(states):
        (final,) = st["clusters"].values()
        # restore original row order ("-stable" muscle flag semantics:
        # output order == input order)
        order = np.argsort(final.rows)
        out.append(final.mat[order])
    return out


def align_families_chunked(families: list[list[np.ndarray]], *,
                           chunk: int = 512, **kw) -> list[np.ndarray]:
    """`align_families` `chunk` families at a time (a chunk of hundreds
    of families still fills the device with full merge waves).  The
    reference also persists each slice to its checkpoint store and polls
    a deadline between slices; neither is ported."""
    n = len(families)
    out: list[np.ndarray] = []
    for s0 in range(0, n, chunk):
        t0 = time.time()
        out.extend(align_families(families[s0:s0 + chunk], **kw))
        log.info("align: %d/%d families (%.1fs slice)",
                 min(s0 + chunk, n), n, time.time() - t0)
    return out


def sp_score(mat: np.ndarray, core: np.ndarray | None = None) -> float:
    """Sum-of-pairs substitution score of the aligned residue pairs —
    the acceptance objective for refinement passes (muscle's refinement
    keeps a pass only when its objective improves).  Computed from
    per-column residue counts (L, 20): pairs_ab(col) = c_a c_b for
    a != b and C(c_a, 2) for a == b.  Gap-residue pairs are ignored."""
    sub = blosum_core(np.float64) if core is None \
        else np.asarray(core, np.float64)
    counts = np.zeros((mat.shape[1], N_AA), np.float64)
    for a in range(N_AA):
        counts[:, a] = (mat == a).sum(axis=0)
    cross = counts.T @ counts  # (20, 20) sum over columns of c_a c_b
    diag_pairs = ((counts * (counts - 1.0)) / 2.0).sum(axis=0)
    off = cross * (1.0 - np.eye(N_AA))
    return float((off * sub).sum() / 2.0
                 + (diag_pairs * np.diag(sub)).sum())


def refine_families(mats: list[np.ndarray], *, iters: int = 1,
                    core: np.ndarray | None = None, device=None,
                    **kw) -> tuple[list[np.ndarray], int]:
    """Muscle-style iterative refinement (MultipleSequenceAligner.java:
    90-141 runs muscle's progressive build plus refinement passes).

    Each pass re-estimates every family's guide tree from the current
    alignment (Kimura-corrected distances over aligned columns,
    `treebuild.protein_distances`), re-aligns through the same batched
    merge waves, and keeps the new alignment only when its sum-of-pairs
    score improves.  Returns (mats, n_improved)."""
    from pepr_tpu_torch.models.treebuild import protein_distances

    mats = list(mats)
    improved_total = 0
    for _ in range(max(iters, 0)):
        # degapped sequences + alignment-informed guide per family
        todo = [i for i, m in enumerate(mats) if m.shape[0] >= 3]
        if not todo:
            break
        fams = []
        guides = []
        for i in todo:
            m = mats[i]
            fams.append([row[row != GAP] for row in m])
            guides.append(upgma(protein_distances(m, device=device)))
        new = align_families(fams, guide_merges=guides, core=core,
                             device=device, **kw)
        improved = 0
        for i, nm in zip(todo, new):
            if sp_score(nm, core) > sp_score(mats[i], core):
                mats[i] = nm
                improved += 1
        improved_total += improved
        if improved == 0:
            break
    return mats, improved_total


def align_family(seqs: list[np.ndarray], **kw) -> np.ndarray:
    return align_families([seqs], **kw)[0]


def align_sequence_sets(sets: list[SequenceSet], **kw) -> list["Alignment"]:
    mats = align_families([s.seqs for s in sets], **kw)
    return [Alignment(s.name, list(s.taxa), m, titles=list(s.titles))
            for s, m in zip(sets, mats)]


@dataclass
class Alignment:
    """An MSA with taxon names per row (SequenceAlignment.java role)."""
    name: str
    taxa: list[str]
    mat: np.ndarray  # (n, L) int8 with GAP
    titles: list[str] | None = None

    @property
    def n_seqs(self) -> int:
        return self.mat.shape[0]

    @property
    def length(self) -> int:
        return self.mat.shape[1]
