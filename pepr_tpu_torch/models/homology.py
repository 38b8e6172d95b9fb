"""All-vs-all protein homology search -> ortholog clusters.

The reference's stage-1 homology pipeline (BlatRunner.java:276-527
all-vs-all blat with top-1 hit per query per target genome;
PhyloPipeline.java:316-431 thresholds hitsPerQuery=1, evalue 0.1,
minIdentity 10, minScore 15; :911-987 bidirectional filter; :882-909
MCL at inflation 1.5):

1. hashed k-mer profiles for every protein (host),
2. candidates: exact k-mer seeds (host, scipy) united with the cosine
   top-k per (query, target genome) (device einsum, ops/kmer_filter.py),
3. exact affine Smith-Waterman on the candidates, length-bucketed,
   through the CUDA kernel on the card (ops/smith_waterman.py,
   csrc/sw.cu),
4. top-1 hit per (query, genome) + blat-style thresholds,
5. bidirectional filter, then Markov clustering (ops/mcl.py).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

import numpy as np
import torch

from pepr_tpu_torch.alphabet import PAD
from pepr_tpu_torch.data.blosum62 import bit_score_to_evalue, raw_to_bit_score
from pepr_tpu_torch.device import resolve_device
from pepr_tpu_torch.io.fasta import SequenceSet
from pepr_tpu_torch.ops.kmer_filter import (DEFAULT_K, candidate_pairs,
                                            kmer_profiles, seed_candidates)
from pepr_tpu_torch.ops.mcl import mcl_cluster
from pepr_tpu_torch.ops.smith_waterman import (kernel_matrix,
                                               sw_align_batch_fast)
from pepr_tpu_torch.ops.sw import integer_sub
from pepr_tpu_torch.pipeline.checkpoint import Incomplete

log = logging.getLogger("pepr_tpu_torch")

# Pairs per SW launch on the card: the codes of a batch (B x (Lq + Lt)
# bytes) stay within this budget; the kernel itself allocates nothing
# per cell.
CARD_BATCH_BYTES = 64 << 20
# Pairs per batch of the plain version on the CPU, whose DP state is
# ~20 (B, Lq) int32 tensors.
CPU_BATCH_CELLS = 1 << 20


@dataclass
class ProteinUniverse:
    """Flat index over all proteins of all genomes."""
    genomes: list[SequenceSet]
    seqs: list[np.ndarray]
    ids: list[str]
    genome_of: np.ndarray  # (N,) int32
    offsets: np.ndarray  # (G+1,)
    lengths: np.ndarray  # (N,)

    @classmethod
    def build(cls, genomes: list[SequenceSet]) -> "ProteinUniverse":
        seqs: list[np.ndarray] = []
        ids: list[str] = []
        genome_of: list[int] = []
        offsets = [0]
        for g, ss in enumerate(genomes):
            seqs.extend(ss.seqs)
            ids.extend(ss.ids)
            genome_of.extend([g] * len(ss))
            offsets.append(len(seqs))
        return cls(genomes, seqs, ids,
                   np.array(genome_of, dtype=np.int32),
                   np.array(offsets, dtype=np.int64),
                   np.array([len(s) for s in seqs], dtype=np.int32))

    @property
    def n(self) -> int:
        return len(self.seqs)

    def genome_residues(self) -> np.ndarray:
        return np.array([sum(len(s) for s in g.seqs) for g in self.genomes],
                        dtype=np.int64)


@dataclass
class HitTable:
    """Directed best hits: query protein -> best match per target genome."""
    query: np.ndarray  # (M,) int64 global protein index
    target: np.ndarray  # (M,)
    raw: np.ndarray  # (M,) float32 raw SW score
    bits: np.ndarray  # (M,) float64 bit score
    evalue: np.ndarray  # (M,)
    identity: np.ndarray  # (M,) percent
    length: np.ndarray  # (M,) aligned columns


def _pow2_len(x, lo: int = 128, hi: int = 4096):
    """Power-of-two bucket length in [lo, hi] (elementwise on arrays)."""
    x = np.minimum(np.maximum(np.asarray(x, dtype=np.int64), 1), hi)
    out = np.maximum(lo, 2 ** np.ceil(np.log2(x)).astype(np.int64))
    return int(out) if out.ndim == 0 else out


def sw_buckets(lens: np.ndarray, pairs_q: np.ndarray, pairs_t: np.ndarray,
               max_len: int = 4096):
    """Orient every pair so the shorter sequence is the DP query (the
    scores and trackers are orientation-invariant: the substitution
    matrices are symmetric) and bucket pairs by the power-of-two lengths
    of (query, target).  Returns (eff_q, eff_t, {(blq, blt): pair
    indices}), buckets in ascending order."""
    lens = np.asarray(lens, dtype=np.int64)
    swap = lens[pairs_q] > lens[pairs_t]
    eff_q = np.where(swap, pairs_t, pairs_q)
    eff_t = np.where(swap, pairs_q, pairs_t)
    blq = _pow2_len(lens[eff_q], hi=max_len)
    blt = _pow2_len(lens[eff_t], hi=max_len)
    key = blq * (max_len + 1) + blt
    order = np.argsort(key, kind="stable")
    uniq, starts = np.unique(key[order], return_index=True)
    ends = np.append(starts[1:], len(order))
    buckets = {(int(u // (max_len + 1)), int(u % (max_len + 1))):
               order[s:e] for u, s, e in zip(uniq, starts, ends)}
    return eff_q, eff_t, buckets


def batch_pairs(blq: int, blt: int, device: torch.device) -> int:
    """Pairs per SW call for a bucket: the card's budget is the codes of
    a batch; the CPU's is the plain version's (B, blq) DP state."""
    if device.type == "cuda":
        return max(1, CARD_BATCH_BYTES // (blq + blt))
    return max(1, CPU_BATCH_CELLS // blq)


def by_real_cells(lens: torch.Tensor, eff_q: torch.Tensor,
                  eff_t: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """A bucket's pair indices `sel`, largest real cell count first
    (ties in their order), on their device: the kernel's warps take a
    launch's pairs in order, so the long pairs start first and the short
    ones fill in behind them."""
    cells = lens[eff_q[sel]] * lens[eff_t[sel]]
    return sel[torch.argsort(cells, descending=True, stable=True)]


def pack_codes(seqs, max_len: int = 4096, device=None) -> torch.Tensor:
    """All codes PAD-filled into one (N, Lmax) int8 tensor on `device`,
    Lmax the power-of-two bucket of the longest sequence."""
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    lmax = _pow2_len(int(lens.max()), hi=max_len)
    packed = np.full((len(seqs), lmax), PAD, dtype=np.int8)
    for i, s in enumerate(seqs):
        n = min(len(s), lmax)
        packed[i, :n] = np.asarray(s[:n], dtype=np.int8)
    return torch.as_tensor(packed, device=device)


def _bucketed_sw(seqs_or_universe, pairs_q: np.ndarray,
                 pairs_t: np.ndarray, max_len: int = 4096,
                 sub: np.ndarray | None = None, gap_open: int = 11,
                 gap_extend: int = 1, store=None, deadline=None,
                 ckpt_key: str | None = None,
                 device=None) -> dict[str, np.ndarray]:
    """Run SW on an arbitrary pair list over a sequence collection
    (a plain list of int8 code arrays, or anything with .seqs).

    All codes are packed once into a device-resident (N, Lmax) int8
    tensor; every batch moves only its two index vectors and gathers
    its (B, blq) and (B, blt) codes on the device.  Pairs are oriented
    short side as query and bucketed by power-of-two lengths
    (`sw_buckets`), and each bucket's pairs sorted by real cells before
    it is cut into batches (`by_real_cells`); results stay on the
    device until a bucket is done and cross to the host once per
    bucket.  Returns score, matches and length per pair (float32
    arrays).

    With `store` and `ckpt_key` the progress is saved as a mask over
    the pairs and their outputs (at most once a minute, at the end,
    and on interruption): a pair's outputs do not depend on the batch
    it ran in, so a store written on one device resumes on another
    whatever their batch plans.  `deadline.near(90.0)` is polled before
    each launch; when it holds, the launches made are synchronized and
    saved and Incomplete is raised.
    """
    dev = resolve_device(device)
    seqs = seqs_or_universe if isinstance(seqs_or_universe, list) \
        else seqs_or_universe.seqs
    n_pairs = len(pairs_q)
    out = {k: np.zeros(n_pairs, dtype=np.float32)
           for k in ("score", "matches", "length")}
    if n_pairs == 0:
        return out
    done = np.zeros(n_pairs, dtype=bool)
    use_ckpt = store is not None and ckpt_key is not None
    if use_ckpt and store.has(ckpt_key):
        st = store.load(ckpt_key)
        done = st["done"]
        for k in out:
            out[k][:] = st["out"][k]
        log.info("sw resume: %d of %d pairs already done", int(done.sum()),
                 n_pairs)
    last_save = time.time()

    def save():
        if use_ckpt:
            store.save(ckpt_key, {"done": done, "out": out})

    sub_dev = integer_sub(kernel_matrix() if sub is None else sub, dev)
    codes_all = pack_codes(seqs, max_len, dev)
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    eff_q, eff_t, buckets = sw_buckets(lens, pairs_q, pairs_t, max_len)
    qi_all = torch.as_tensor(eff_q, device=dev)
    ti_all = torch.as_tensor(eff_t, device=dev)
    lens_all = torch.as_tensor(lens, device=dev)
    for (blq, blt), idxs in buckets.items():
        idxs = idxs[~done[idxs]]
        if len(idxs) == 0:
            continue
        t0 = time.time()
        step = batch_pairs(blq, blt, dev)
        sel_all = by_real_cells(lens_all, qi_all, ti_all,
                                torch.as_tensor(idxs, device=dev))
        parts = []
        n_run = 0
        stop = False
        for s0 in range(0, len(idxs), step):
            if deadline is not None and deadline.near(90.0):
                stop = True
                break
            sel = sel_all[s0:s0 + step]
            qb = codes_all[qi_all[sel], :blq]
            tb = codes_all[ti_all[sel], :blt]
            res = sw_align_batch_fast(qb, tb, sub_dev, gap_open=gap_open,
                                      gap_extend=gap_extend)
            parts.append(torch.stack([res["score"],
                                      res["matches"].to(torch.float32),
                                      res["length"].to(torch.float32)]))
            n_run += len(sel)
        if parts:
            got = torch.cat(parts, dim=1).cpu().numpy()
            order = sel_all[:n_run].cpu().numpy()
            for row, k in enumerate(("score", "matches", "length")):
                out[k][order] = got[row]
            done[order] = True
            log.info("sw bucket (%d,%d): %d pairs in %.2fs", blq, blt,
                     n_run, time.time() - t0)
        if stop:
            save()
            raise Incomplete("homology SW")
        if use_ckpt and time.time() - last_save > 60.0:
            save()
            last_save = time.time()
    save()
    return out


def candidate_union(universe: ProteinUniverse, *,
                    candidates_per_genome: int = 2,
                    prefilter_min_sim: float = 0.1, profile_dim: int = 1024,
                    seed_top_per_genome: int = 4, seed_k: int | None = None,
                    seed_min_shared: int = 1, seed_max_df: int = 200,
                    alphabet: str = "aa", device=None,
                    timings: dict | None = None):
    """The SW pair list of `search_all_vs_all`: the union, deduplicated
    on (query, target), of the exact k-mer seed candidates and the
    hashed-cosine top-k.  Returns (pairs_q, pairs_t) int64, sorted."""
    timings = {} if timings is None else timings
    is_nt = alphabet == "nt"
    t0 = time.time()
    profiles = kmer_profiles(universe.seqs, dim=profile_dim,
                             k=12 if is_nt else DEFAULT_K)
    timings["profiles"] = time.time() - t0
    log.info("homology: %d profiles in %.1fs", universe.n,
             timings["profiles"])
    t0 = time.time()
    cand_idx, _ = candidate_pairs(profiles, profiles, universe.offsets,
                                  top_per_genome=candidates_per_genome,
                                  min_sim=prefilter_min_sim, device=device)
    timings["cosine_candidates"] = time.time() - t0
    log.info("homology: cosine candidates in %.1fs",
             timings["cosine_candidates"])
    t0 = time.time()
    seed_idx = seed_candidates(
        universe.seqs, universe.seqs, universe.offsets,
        k=seed_k if seed_k is not None else (12 if is_nt else 5),
        alphabet_size=4 if is_nt else 20, min_shared=seed_min_shared,
        top_per_genome=seed_top_per_genome, max_df=seed_max_df)
    timings["seed_candidates"] = time.time() - t0
    log.info("homology: seed candidates in %.1fs",
             timings["seed_candidates"])
    q_c, _, _ = np.nonzero(cand_idx >= 0)
    t_c = cand_idx[cand_idx >= 0].astype(np.int64)
    q_s, _, _ = np.nonzero(seed_idx >= 0)
    t_s = seed_idx[seed_idx >= 0].astype(np.int64)
    q_all = np.concatenate([q_c.astype(np.int64), q_s.astype(np.int64)])
    t_all = np.concatenate([t_c, t_s])
    key = np.unique(q_all * np.int64(universe.n) + t_all)
    log.info("homology: %d seed + %d cosine -> %d union pairs",
             len(q_s), len(q_c), len(key))
    return key // universe.n, key % universe.n


def search_all_vs_all(genomes: list[SequenceSet], *,
                      hits_per_query: int = 1,
                      evalue_cutoff: float = 0.1,
                      min_identity: float = 10.0,
                      min_score: float = 15.0,
                      candidates_per_genome: int = 2,
                      prefilter_min_sim: float = 0.1,
                      profile_dim: int = 1024,
                      seed_top_per_genome: int = 4,
                      seed_k: int | None = None,
                      seed_min_shared: int = 1,
                      seed_max_df: int = 200,
                      store=None,
                      deadline=None,
                      alphabet: str = "aa",
                      device=None,
                      timings: dict | None = None,
                      counts: dict | None = None) -> tuple[ProteinUniverse,
                                                           HitTable]:
    """Find, for every protein, its best hit in every genome (including
    its own), with blat-equivalent thresholds.

    Candidate generation is the union of two stages, both feeding the
    exact Smith-Waterman scorer (`candidate_union`):
      (a) exact k-mer seed sharing (`ops.kmer_filter.seed_candidates`)
          — the blat-faithful stage (blat -prot defaults: 5-residue
          tiles, stepSize=1, a single shared tile seeds an extension;
          BlatRunner.java:424-430), top `seed_top_per_genome` targets
          per genome ranked by shared-tile count;
      (b) hashed-cosine profile top-k (`candidate_pairs`) — a recall
          backstop for diverged pairs whose conservation is spread
          thinner than any exact 5-mer.

    alphabet="nt" switches to the blastn-equivalent nucleotide search
    (BlastRunner.java:603-706): +1/-3 match/mismatch scores, 5/2 affine
    gaps, blastn Karlin-Altschul statistics, and k=12 for the
    prefilters.  `device` (`resolve_device`: the card unless "cpu")
    runs the cosine top-k and SW; `timings`, if given, receives the
    seconds of each sub-phase (profiles, cosine_candidates,
    seed_candidates, sw, hit_ranking) and `counts` the number of SW
    pairs (sw_pairs).  With a `store` the pair list is saved under
    `s1_sw_pairs` and SW's progress under `s1_sw_out`; `deadline` is
    polled before each SW launch (`_bucketed_sw`)."""
    dev = resolve_device(device)
    timings = {} if timings is None else timings
    counts = {} if counts is None else counts
    universe = ProteinUniverse.build(genomes)
    is_nt = alphabet == "nt"
    if is_nt:
        from pepr_tpu_torch.data.nt_scores import (NT_GAP_EXTEND, NT_GAP_OPEN,
                                                   nt_kernel_matrix,
                                                   nt_raw_to_bit_score)

    def cands():
        return candidate_union(
            universe, candidates_per_genome=candidates_per_genome,
            prefilter_min_sim=prefilter_min_sim, profile_dim=profile_dim,
            seed_top_per_genome=seed_top_per_genome, seed_k=seed_k,
            seed_min_shared=seed_min_shared, seed_max_df=seed_max_df,
            alphabet=alphabet, device=dev, timings=timings)

    pairs_q, pairs_t = store.cached("s1_sw_pairs", cands) \
        if store is not None else cands()
    counts["sw_pairs"] = len(pairs_q)
    t0 = time.time()
    res = _bucketed_sw(universe, pairs_q, pairs_t,
                       sub=nt_kernel_matrix() if is_nt else None,
                       gap_open=NT_GAP_OPEN if is_nt else 11,
                       gap_extend=NT_GAP_EXTEND if is_nt else 1,
                       store=store, deadline=deadline, ckpt_key="s1_sw_out",
                       device=dev)
    timings["sw"] = time.time() - t0
    log.info("homology: SW on %d pairs in %.1fs", len(pairs_q),
             timings["sw"])

    # top-k per (query, target genome) by raw score (vectorized rank)
    t0 = time.time()
    raw = res["score"]
    tg = universe.genome_of[pairs_t].astype(np.int64)
    order = np.lexsort((-raw, tg, pairs_q))
    key = pairs_q[order] * len(universe.genomes) + tg[order]
    new_group = np.ones(len(order), dtype=bool)
    new_group[1:] = key[1:] != key[:-1]
    group_start = np.maximum.accumulate(
        np.where(new_group, np.arange(len(order)), 0))
    rank = np.arange(len(order)) - group_start
    keep = order[rank < hits_per_query]
    genome_res = universe.genome_residues()

    kq, kt = pairs_q[keep], pairs_t[keep]
    kraw = raw[keep]
    kmatch = res["matches"][keep]
    klen = np.maximum(res["length"][keep], 1)
    bits = nt_raw_to_bit_score(kraw) if is_nt else raw_to_bit_score(kraw)
    ev = bit_score_to_evalue(bits, universe.lengths[kq],
                             genome_res[universe.genome_of[kt]])
    ident = 100.0 * kmatch / klen
    # blat-style minScore: matches minus mismatches (gap-free approx)
    blat_score = kmatch - (klen - kmatch)
    ok = (ev <= evalue_cutoff) & (ident >= min_identity) & \
        (blat_score >= min_score) & (kraw > 0)
    timings["hit_ranking"] = time.time() - t0
    return universe, HitTable(kq[ok], kt[ok], kraw[ok], bits[ok], ev[ok],
                              ident[ok], klen[ok])


def _packed_pair_groups(q: np.ndarray, t: np.ndarray):
    """Sort hits by packed unordered-pair key; returns (lo, hi, key,
    order, group-start mask) — shared plumbing for the edge filters."""
    lo = np.minimum(q, t).astype(np.int64)
    hi = np.maximum(q, t).astype(np.int64)
    n = max(int(hi.max()) + 1, 1) if len(hi) else 1
    key = lo * n + hi
    order = np.argsort(key, kind="stable")
    ks = key[order]
    first = np.ones(len(ks), dtype=bool)
    first[1:] = ks[1:] != ks[:-1]
    return lo, hi, key, order, first


def bidirectional_edges(hits: HitTable) -> tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]:
    """Keep only pairs hit in both directions; returns undirected edges
    (i, j, weight=max bit score of the two directions).  Self hits can
    never be bidirectional (PhyloPipeline.filterForBidirectional:
    the unordered pair must be seen twice)."""
    if len(hits.query) == 0:
        return (np.zeros(0, np.int64),) * 2 + (np.zeros(0),)
    lo, hi, key, order, first = _packed_pair_groups(hits.query, hits.target)
    starts = np.nonzero(first)[0]
    counts = np.diff(np.append(starts, len(order)))
    wmax = np.maximum.reduceat(hits.bits[order].astype(np.float64), starts)
    keep = counts >= 2  # pair seen in both directions
    sel = order[starts[keep]]
    return lo[sel], hi[sel], wmax[keep]


def all_edges(hits: HitTable) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Non-bidirectional variant (filterHitPairFile): every directed hit
    becomes an edge; duplicates collapse to max; self loops dropped."""
    nz = hits.query != hits.target
    q, t, b = hits.query[nz], hits.target[nz], hits.bits[nz]
    if len(q) == 0:
        return (np.zeros(0, np.int64),) * 2 + (np.zeros(0),)
    lo, hi, key, order, first = _packed_pair_groups(q, t)
    starts = np.nonzero(first)[0]
    wmax = np.maximum.reduceat(b[order].astype(np.float64), starts)
    sel = order[starts]
    return lo[sel], hi[sel], wmax


def cluster_homolog_groups(universe: ProteinUniverse, hits: HitTable, *,
                           bidirectional: bool = True,
                           inflation: float = 1.5,
                           min_size: int = 2,
                           device=None) -> list[list[int]]:
    """MCL over the hit graph -> homolog groups (protein index lists),
    largest first (the reference extracts sets in mcl output order,
    which is size-sorted)."""
    if bidirectional:
        ei, ej, w = bidirectional_edges(hits)
    else:
        ei, ej, w = all_edges(hits)
    clusters = mcl_cluster(universe.n, ei, ej, w, inflation=inflation,
                           device=device)
    clusters = [c for c in clusters if len(c) >= min_size]
    clusters.sort(key=len, reverse=True)
    return clusters


def groups_to_sequence_sets(universe: ProteinUniverse,
                            clusters: list[list[int]],
                            prefix: str = "set") -> list[SequenceSet]:
    """Materialize homolog groups as SequenceSets (the role of
    SequenceSetExtractor.java:141-198), keeping full titles so taxon
    extraction keeps working downstream."""
    out = []
    # map global index -> (genome, local)
    local = np.zeros(universe.n, dtype=np.int64)
    for g in range(len(universe.genomes)):
        a, b = universe.offsets[g], universe.offsets[g + 1]
        local[a:b] = np.arange(b - a)
    for ci, cluster in enumerate(clusters):
        titles = []
        seqs = []
        for idx in cluster:
            g = int(universe.genome_of[idx])
            li = int(local[idx])
            titles.append(universe.genomes[g].titles[li])
            seqs.append(universe.genomes[g].seqs[li])
        out.append(SequenceSet(f"{prefix}_{ci}", titles, seqs))
    return out
