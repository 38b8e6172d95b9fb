"""HMM-based homolog-group enhancement + outgroup selection (PyTorch
port of `pepr_tpu/models/hmm_enhancer.py`).

Re-design of HMMSetEnhancer (HMMSetEnhancer.java:86-324): align each
homolog group, build a profile HMM per group (ops/hmm.py), score every
genome's proteins (ingroup + outgroup pool) against the profiles (the
k-mer consensus prefilter, then Forward DP through the card's kernel:
the role of `hmmsearch --tblout -E 1e-40`), pick the `outgroup_count`
pool genomes with the highest summed best-hit scores, and rebuild each
group from its score-ranked hits, adding members until a genome repeats
(HMMSetEnhancer.java:241-288).

Deliberate divergence, kept from the JAX package: the reference's
outgroup ranking loop reads `hmmScoreSums[i]` with the wrong loop
variable (HMMSetEnhancer.java:191), which tends to pick pool genomes in
file order; the ranking here is by the actual score sums.

With a checkpoint `store` the group alignments (slices under
`hmm_align_chunk_{i}`, then `hmm_group_alignments`), the prefilter's
pairs (`hmm_pairs`) and the scores (progress under `hmm_viterbi`, then
`hmm_scores`) are saved as in the JAX package, and `deadline` is polled
after each of them.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

import numpy as np

from pepr_tpu_torch.alphabet import GAP, N_AA, PAD
from pepr_tpu_torch.device import resolve_device
from pepr_tpu_torch.io.fasta import SequenceSet
from pepr_tpu_torch.models.msa import align_families_chunked
from pepr_tpu_torch.ops.hmm import (ProfileHMM, build_profile_hmm,
                                    profile_score_pairs)
from pepr_tpu_torch.ops.kmer_filter import (candidate_pairs, kmer_profiles,
                                            seed_candidates)
from pepr_tpu_torch.pipeline.checkpoint import check_deadline

log = logging.getLogger("pepr_tpu_torch")

CONSENSUS_BLOCK = 2048  # consensi per block of the prefilters' top-k


def consensus_sequence(aln: np.ndarray) -> np.ndarray:
    """Majority residue per column (gap columns dropped): the k-mer
    prefilter key for a profile."""
    n, L = aln.shape
    counts = np.zeros((N_AA, L), dtype=np.int32)
    for a in range(N_AA):
        counts[a] = (aln == a).sum(axis=0)
    best = counts.argmax(axis=0).astype(np.int8)
    gaps = ((aln == GAP) | (aln == PAD)).sum(axis=0)
    keep = gaps <= n // 2
    return best[keep] if keep.any() else best


@dataclass
class EnhancerResult:
    enhanced_sets: list[SequenceSet]
    selected_outgroups: list[str]
    genome_scores: dict[str, float] = field(default_factory=dict)


def prefilter_pairs(seqs: list[np.ndarray], consensi: list[np.ndarray],
                    candidates_per_block: int, min_sim: float,
                    device) -> list[tuple[int, int]]:
    """(protein, profile) pairs: the union of the exact-seed sharing and
    the hashed-cosine candidates against the group consensi, each a
    top-k per protein per block of CONSENSUS_BLOCK consensi, sorted."""
    prof_prot = kmer_profiles(seqs)
    prof_cons = kmer_profiles(consensi)
    offsets = np.arange(0, len(consensi) + CONSENSUS_BLOCK, CONSENSUS_BLOCK,
                        dtype=np.int64)
    offsets[-1] = min(int(offsets[-1]), len(consensi))
    offsets = np.unique(offsets)
    cand, _ = candidate_pairs(prof_prot, prof_cons, offsets,
                              top_per_genome=candidates_per_block,
                              min_sim=min_sim, device=device)
    seed = seed_candidates(seqs, consensi, offsets,
                           top_per_genome=candidates_per_block)
    p_c, _, _ = np.nonzero(cand >= 0)
    h_c = cand[cand >= 0].astype(np.int64)
    p_s, _, _ = np.nonzero(seed >= 0)
    h_s = seed[seed >= 0].astype(np.int64)
    nh = np.int64(max(len(consensi), 1))
    key = np.unique(np.concatenate([p_c.astype(np.int64) * nh + h_c,
                                    p_s.astype(np.int64) * nh + h_s]))
    return list(zip((key // nh).tolist(), (key % nh).tolist()))


def enhance_homolog_groups(hg_sets: list[SequenceSet],
                           ingroup: list[SequenceSet],
                           outgroup_pool: list[SequenceSet],
                           outgroup_count: int = 2,
                           min_bits: float = 100.0,
                           candidates_per_block: int = 6,
                           prefilter_min_sim: float = 0.1,
                           store=None, deadline=None, device=None,
                           timings: dict | None = None,
                           counts: dict | None = None) -> EnhancerResult:
    """The enhanced groups and the selected outgroup genomes, on
    `device` (the card unless "cpu").  `timings` receives the seconds
    of the alignment, the prefilter and the scoring; `counts` the
    prefilter's pairs and the scorer's counts (`profile_score_pairs`).
    `store` and `deadline` (both optional) make the run resumable: see
    the module docstring."""
    dev = resolve_device(device)
    timings = {} if timings is None else timings
    if not hg_sets:
        return EnhancerResult([], [])
    # 1. align groups, build profiles + consensus keys (slices saved:
    # thousands of groups can take several deadline slices)
    t0 = time.time()
    if store is not None and store.has("hmm_group_alignments"):
        mats = store.load("hmm_group_alignments")
    else:
        mats = align_families_chunked(
            [s.seqs for s in hg_sets], store=store, deadline=deadline,
            ckpt_key="hmm_align_chunk", device=dev)
        if store is not None:
            store.save("hmm_group_alignments", mats)
    log.info("enhancer: %d group alignments ready", len(mats))
    check_deadline(deadline, "group alignment")
    hmms: list[ProfileHMM] = []
    consensi: list[np.ndarray] = []
    for s, m in zip(hg_sets, mats):
        hmms.append(build_profile_hmm(m, name=s.name))
        consensi.append(consensus_sequence(m))
    timings["hmm_align"] = time.time() - t0

    # 2. flat protein axis over all genomes (pool first, then ingroup:
    # the search covers both, HMMSetEnhancer.java:136-140)
    genomes = list(outgroup_pool) + list(ingroup)
    n_pool = len(outgroup_pool)
    seqs: list[np.ndarray] = []
    genome_of: list[int] = []
    titles: list[tuple[int, int]] = []  # (genome, local index)
    for gi, g in enumerate(genomes):
        for li, s in enumerate(g.seqs):
            seqs.append(s)
            genome_of.append(gi)
            titles.append((gi, li))
    genome_of = np.array(genome_of, dtype=np.int64)

    # 3. prefilter: exact-seed sharing vs group consensi, united with
    # hashed-cosine profiles in blocks (the seed stage gives the
    # enhancer blat-level recall; it cannot re-admit a member its
    # prefilter never surfaces)
    t0 = time.time()

    def prefilter():
        return prefilter_pairs(seqs, consensi, candidates_per_block,
                               prefilter_min_sim, dev)

    pairs = store.cached("hmm_pairs", prefilter) if store is not None \
        else prefilter()
    timings["hmm_prefilter"] = time.time() - t0
    log.info("enhancer: scoring %d (protein, profile) pairs", len(pairs))
    check_deadline(deadline, "profile prefilter")

    # 4. exact profile scores, and the scorer's counts with them
    t0 = time.time()

    def score():
        scored: dict = {}
        bits = profile_score_pairs(seqs, hmms, pairs, store=store,
                                   deadline=deadline, ckpt_key="hmm_viterbi",
                                   device=dev, counts=scored)
        return bits, scored

    bits, scored = store.cached("hmm_scores", score) if store is not None \
        else score()
    timings["hmm_scoring"] = time.time() - t0
    if counts is not None:
        counts["hmm_prefilter_pairs"] = len(pairs)
        counts.update({f"hmm_{k}": v for k, v in scored.items()})
    check_deadline(deadline, "profile scoring")

    # best hit per (genome, hg) and per (protein, hg)
    best_gh: dict[tuple[int, int], tuple[float, int]] = {}
    hg_hits: dict[int, list[tuple[float, int]]] = {}
    for (p, h), b in zip(pairs, bits):
        if b < min_bits:
            continue
        g = int(genome_of[p])
        cur = best_gh.get((g, h))
        if cur is None or b > cur[0]:
            best_gh[(g, h)] = (float(b), p)
        hg_hits.setdefault(h, []).append((float(b), p))

    # 5. outgroup selection: summed best-per-HG scores over pool genomes
    pool_scores = np.zeros(max(n_pool, 1))
    for (g, h), (b, _) in best_gh.items():
        if g < n_pool:
            pool_scores[g] += b
    order = np.argsort(-pool_scores)
    selected = [int(i) for i in order[:outgroup_count]
                if n_pool and pool_scores[i] > 0]
    selected_names = [genomes[i].taxon for i in selected]
    allowed_genomes = set(selected) | set(range(n_pool, len(genomes)))

    # 6. rebuild sets: rank hits, add members until a genome repeats.
    # Equal-score repeats are skipped rather than truncating
    # (HMMSetEnhancer.java:266-279): an exact duplicate gene (two
    # identical copies in one genome) must not end the set early.
    enhanced: list[SequenceSet] = []
    for h, s in enumerate(hg_sets):
        hits = sorted(hg_hits.get(h, []), reverse=True)
        new_titles: list[str] = []
        new_seqs: list[np.ndarray] = []
        genome_score: dict[int, float] = {}
        for b, p in hits:
            gi, li = titles[p]
            if gi not in allowed_genomes:
                continue
            if gi in genome_score:
                if b == genome_score[gi]:
                    continue  # duplicate gene, not a paralog: skip
                break  # lower-scoring repeat genome ends the set
            genome_score[gi] = b
            new_titles.append(genomes[gi].titles[li])
            new_seqs.append(genomes[gi].seqs[li])
        if len(new_seqs) >= 2:
            enhanced.append(SequenceSet(s.name, new_titles, new_seqs))
        else:
            enhanced.append(s)  # keep original if scoring found nothing
    gscores = {genomes[i].taxon: float(pool_scores[i])
               for i in range(n_pool)}
    return EnhancerResult(enhanced, selected_names, gscores)
