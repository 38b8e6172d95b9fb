"""Stage 1: genomes -> homolog groups -> outgroup selection.

Orchestration replacing PhyloPipeline's constructor pipeline
(PhyloPipeline.java:111-579): all-vs-all homology search over the
ingroup (blat defaults: top-1 hit/query/genome, evalue 0.1,
minIdentity 10, minScore 15 — :323-326), bidirectional filter
(:911-987), MCL at inflation 1.5 (:882-909), homolog-group extraction
(:398-431), then outgroup scoring/selection against the outgroup pool
(the role of HMMSetEnhancer.java:165-215: per-genome score sums pick
the top `outgroup_count` pool genomes, and each selected genome's best
member joins each group).  With `use_hmm` (the reference default) the
profile-HMM enhancer (models/hmm_enhancer.py, scoring through the
card's Forward kernel) rebuilds the groups and selects the outgroups;
otherwise the Smith-Waterman scorer selects them.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

import numpy as np

from pepr_tpu_torch.device import resolve_device
from pepr_tpu_torch.io.fasta import SequenceSet
from pepr_tpu_torch.models.homology import (ProteinUniverse, _bucketed_sw,
                                            cluster_homolog_groups,
                                            groups_to_sequence_sets,
                                            search_all_vs_all)
from pepr_tpu_torch.ops.kmer_filter import (DEFAULT_K, candidate_pairs,
                                            kmer_profiles)
from pepr_tpu_torch.pipeline.checkpoint import check_deadline

log = logging.getLogger("pepr_tpu_torch")


@dataclass
class Stage1Config:
    hits_per_query: int = 1
    evalue_cutoff: float = 0.1
    min_identity: float = 10.0
    min_score: float = 15.0
    bidirectional: bool = True
    inflation: float = 1.5
    min_cluster_size: int = 2
    outgroup_count: int = 2
    outgroup_min_bits: float = 50.0  # analog of hmmsearch -E 1e-40
    use_hmm: bool = True  # HMM set enhancement (the reference default)
    # the HMM enhancer's cutoff on the HMMER bit scale, S >= log2(N/E)
    # ~ 144 bits for the reference's `-E 1e-40` at ~3k-protein genomes
    # (HMMSetEnhancer.java:527-530)
    hmm_min_bits: float = 144.0
    unique_species: bool = False
    unique_genus: bool = False
    homology_file: str | None = None  # precomputed blast8 results
    seed: int = 12345
    # "nt" switches homology search to the blastn-equivalent scoring
    # (BlastRunner.java:603-706)
    alphabet: str = field(default="aa", repr=False)


@dataclass
class Stage1Result:
    universe: ProteinUniverse
    hg_sets: list[SequenceSet]
    selected_outgroups: list[str]  # taxon names
    timings: dict = field(default_factory=dict)
    # sizes along the way: sw_pairs, hits, groups; with use_hmm the
    # enhancer's prefilter pairs, scored pairs by bucket, padded and real
    # DP cells (hmm_*)
    counts: dict = field(default_factory=dict)


def filter_duplicate_species(genomes: list[SequenceSet],
                             genus_only: bool = False) -> list[SequenceSet]:
    """Keep one genome per species (first two name tokens) or genus
    (first token), preferring the genome with more genes
    (PhyloPipeline.java:718-806)."""
    kept: dict[str, SequenceSet] = {}
    order: list[str] = []
    for g in genomes:
        toks = g.taxon.split("_")
        key = toks[0] if genus_only else "_".join(toks[:2])
        cur = kept.get(key)
        if cur is None:
            kept[key] = g
            order.append(key)
        elif len(g) > len(cur):
            kept[key] = g
    return [kept[k] for k in order]


def score_outgroups(hg_sets: list[SequenceSet], pool: list[SequenceSet],
                    cfg: Stage1Config, alphabet: str = "aa", device=None):
    """Score every outgroup-pool genome against the homolog groups.

    The role of HMMSetEnhancer's hmmsearch sweep (HMMSetEnhancer.java:
    146-215): each pool protein is searched against the group members
    (k-mer candidates + exact SW), hits are mapped to the HG of the hit
    protein, and a genome's score is the sum over HGs of its best
    member's bit score.  The members form the target axis in blocks of
    4096 proteins, each block taking the place of a genome in the
    per-block top-k.  Returns (selected pool genome indices,
    {(genome, hg) -> (bits, pool protein index)}).
    """
    if not pool or not hg_sets:
        return [], {}
    target_seqs: list[np.ndarray] = []
    target_hg: list[int] = []
    for hg_i, s in enumerate(hg_sets):
        target_seqs.extend(s.seqs)
        target_hg.extend([hg_i] * len(s))
    target_hg = np.array(target_hg, dtype=np.int64)
    block = 4096
    n_t = len(target_seqs)
    offsets = np.arange(0, n_t + block, block, dtype=np.int64)
    offsets[-1] = min(int(offsets[-1]), n_t)
    offsets = np.unique(offsets)

    pool_seqs: list[np.ndarray] = []
    pool_genome: list[int] = []
    for gi, g in enumerate(pool):
        pool_seqs.extend(g.seqs)
        pool_genome.extend([gi] * len(g))
    pool_genome = np.array(pool_genome, dtype=np.int64)

    _k = 12 if alphabet == "nt" else DEFAULT_K
    prof_q = kmer_profiles(pool_seqs, k=_k)
    prof_t = kmer_profiles(target_seqs, k=_k)
    # top candidates per pool protein per target block
    cand_idx, _ = candidate_pairs(prof_q, prof_t, offsets,
                                  top_per_genome=3, device=device)
    flat = cand_idx.reshape(len(pool_seqs), -1)
    qs_arr, col = np.nonzero(flat >= 0)
    ts_arr = flat[qs_arr, col].astype(np.int64)
    if len(qs_arr) == 0:
        return [], {}

    if alphabet == "nt":
        from pepr_tpu_torch.data.nt_scores import (NT_GAP_EXTEND, NT_GAP_OPEN,
                                                   nt_kernel_matrix,
                                                   nt_raw_to_bit_score)
        res = _bucketed_sw(pool_seqs + target_seqs,
                           qs_arr.astype(np.int64),
                           ts_arr + len(pool_seqs),
                           sub=nt_kernel_matrix(),
                           gap_open=NT_GAP_OPEN,
                           gap_extend=NT_GAP_EXTEND, device=device)
        bits = nt_raw_to_bit_score(res["score"])
    else:
        res = _bucketed_sw(pool_seqs + target_seqs,
                           qs_arr.astype(np.int64),
                           ts_arr + len(pool_seqs), device=device)
        from pepr_tpu_torch.data.blosum62 import raw_to_bit_score
        bits = raw_to_bit_score(res["score"])

    best: dict[tuple[int, int], tuple[float, int]] = {}
    for q, t, b in zip(qs_arr, ts_arr, bits):
        b = float(b)
        if b < cfg.outgroup_min_bits:
            continue
        key = (int(pool_genome[q]), int(target_hg[t]))
        cur = best.get(key)
        if cur is None or b > cur[0]:
            best[key] = (b, int(q))
    genome_scores = np.zeros(len(pool))
    for (g, hg), (b, _) in best.items():
        genome_scores[g] += b
    order = np.argsort(-genome_scores)
    selected = [int(i) for i in order[: cfg.outgroup_count]
                if genome_scores[i] > 0]
    return selected, best


def run_stage1(ingroup: list[SequenceSet], outgroup_pool: list[SequenceSet],
               cfg: Stage1Config | None = None, store=None, deadline=None,
               device=None) -> Stage1Result:
    """Homolog groups of the ingroup and the selected outgroups, on
    `device` (`resolve_device`: the card unless "cpu").  With a
    checkpoint `store` the hits (`s1_hits`, the search's own progress
    under `s1_sw_pairs` and `s1_sw_out`), the clusters (`s1_clusters`)
    and the enhancer's parts are saved; `deadline` is polled after the
    homology search, MCL and the HMM enhancement."""
    cfg = cfg or Stage1Config()
    dev = resolve_device(device)
    timings: dict = {}
    counts: dict = {}

    genomes = ingroup
    if cfg.unique_species or cfg.unique_genus:
        genomes = filter_duplicate_species(genomes, cfg.unique_genus)

    t0 = time.time()
    universe = ProteinUniverse.build(genomes)

    def search():
        if cfg.homology_file:
            # precomputed results (-homology_search_method <file>,
            # PhyloPipeline.java:340-356)
            from pepr_tpu_torch.io.hits import read_blast8
            return read_blast8(cfg.homology_file, universe), {}
        found: dict = {}
        _, hits = search_all_vs_all(
            genomes, hits_per_query=cfg.hits_per_query,
            evalue_cutoff=cfg.evalue_cutoff,
            min_identity=cfg.min_identity, min_score=cfg.min_score,
            store=store, deadline=deadline, alphabet=cfg.alphabet,
            device=dev, timings=timings, counts=found)
        return hits, found

    # the hits with the search's counts (sw_pairs)
    hits, found = store.cached("s1_hits", search) if store is not None \
        else search()
    counts.update(found)
    timings["homology_search"] = time.time() - t0
    counts["hits"] = len(hits.query)
    log.info("stage1: homology search done in %.1fs (%d hits)",
             timings["homology_search"], len(hits.query))
    check_deadline(deadline, "homology search")

    t0 = time.time()

    def clusters():
        return cluster_homolog_groups(
            universe, hits, bidirectional=cfg.bidirectional,
            inflation=cfg.inflation, min_size=cfg.min_cluster_size,
            device=dev)

    hg_sets = groups_to_sequence_sets(
        universe, store.cached("s1_clusters", clusters)
        if store is not None else clusters())
    timings["mcl"] = time.time() - t0
    counts["groups"] = len(hg_sets)
    log.info("stage1: MCL done in %.1fs (%d groups)", timings["mcl"],
             len(hg_sets))
    check_deadline(deadline, "mcl")

    if cfg.use_hmm:
        from pepr_tpu_torch.models.hmm_enhancer import enhance_homolog_groups
        t0 = time.time()
        # the HMM sweep searches every genome, re-admitting any
        # duplicate-species genomes left out of the homology search
        # (PhyloPipeline.java:274-276 comment + HMMSetEnhancer flow)
        enh = enhance_homolog_groups(
            hg_sets, ingroup, outgroup_pool,
            outgroup_count=cfg.outgroup_count if outgroup_pool else 0,
            min_bits=cfg.hmm_min_bits, store=store, deadline=deadline,
            device=dev, timings=timings, counts=counts)
        timings["hmm_enhancement"] = time.time() - t0
        log.info("stage1: HMM enhancement done in %.1fs (outgroups: %s)",
                 timings["hmm_enhancement"], enh.selected_outgroups)
        check_deadline(deadline, "hmm enhancement")
        return Stage1Result(universe, enh.enhanced_sets,
                            enh.selected_outgroups, timings, counts)

    selected_names: list[str] = []
    if outgroup_pool and cfg.outgroup_count > 0:
        t0 = time.time()
        selected, best = score_outgroups(hg_sets, outgroup_pool, cfg,
                                         alphabet=cfg.alphabet, device=dev)
        selected_names = [outgroup_pool[g].taxon for g in selected]
        pool_offsets = np.cumsum([0] + [len(g) for g in outgroup_pool])
        # add each selected genome's best member to each group
        for hg_i, s in enumerate(hg_sets):
            for g in selected:
                hit = best.get((g, hg_i))
                if hit is None:
                    continue
                _, prot = hit
                local = prot - int(pool_offsets[g])
                src = outgroup_pool[g]
                s.titles.append(src.titles[local])
                s.seqs.append(src.seqs[local])
                s._taxa = None
                s._id_index = None
        timings["outgroup_selection"] = time.time() - t0

    return Stage1Result(universe, hg_sets, selected_names, timings, counts)
