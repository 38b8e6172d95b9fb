"""Profile HMMs: build from an MSA, score proteins with Forward or
Viterbi DP (PyTorch port of `pepr_tpu/ops/hmm.py`; Forward is the
production default, hmmsearch's reported full-sequence bit score being
a Forward score).

The compute replacement for HMMER3's hmmbuild/hmmsearch as the
reference uses them (HMMSetEnhancer.java:483-532: one HMM per homolog
group built from its muscle alignment, then searched against every
genome, keeping full-sequence scores).

Model: Plan7-style profile with match/insert/delete states, uniform
local entry/exit (multihit omitted).  Build follows HMMER's
architecture rule: alignment columns with gap fraction <= 0.5 become
match states; emissions are observed frequencies smoothed with
background pseudocounts and entropy-weighted; scores are log2-odds
against the WAG equilibrium frequencies.  `build_profile_hmm` and
`pack_profiles` are numpy, copied from the JAX package, so builds are
bit-identical.

Scoring.  `viterbi_segment` / `viterbi_score_batch` are the plain
PyTorch version of the DP, step for step the JAX package's `lax.scan`
(the NEG = -1e30 sentinel, pre-shifted transitions, the Kogge-Stone
delete chain in the same doubling order, `_lse2`, the `live` mask).
On the card `profile_score_pairs` launches the hand-written kernel of
`ops/hmm_kernel.py` (`csrc/hmm.cu`) on the device-resident packs, each
laid out once for its walk (`walk_pack`); on the CPU it gathers each
chunk and runs the plain version.  There is no other route.

What the port keeps and cuts of the reference's batching
(`score_plan`, and `card_score_plan` on the card):
- On the CPU the length buckets are kept: sequences in factor-4 buckets
  from 128, profiles from 64, both capped at 4,096 (`p4`), so a longer
  sequence is cut to 4,096 residues as the reference cuts it, and
  scores are comparable pair for pair.  The batch sizes per bucket
  (`eff`) are kept too.  The buckets exist for TPU compile time.
- On the card the profiles keep their mpad packs, but each pack is one
  launch over all its pairs, lpad at the cap (a pair's score depends on
  lpad only through it), longest pairs first: the kernel walks only
  real cells, so the reference's buckets would only strand long pairs
  in small launches.  `counts` still reports the reference buckets'
  pairs and padded and real cells.
- The reference's `BoundedDispatch(window=4)`, which bounded the
  remote TPU worker's in-flight gathered slabs, is replaced by plain
  stream ordering and one host sync per bucket: the kernel reads the
  packs directly and holds no per-pair slab.
- The reference's chunk checkpoints keyed by launch shape
  (lpad, mpad, s0) are a mask over the pairs here, so the card's plan
  and the CPU's buckets resume one store.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from pepr_tpu_torch.alphabet import GAP, N_AA, PAD
from pepr_tpu_torch.data.wag import WAG_FREQS
from pepr_tpu_torch.device import resolve_device
from pepr_tpu_torch.pipeline.checkpoint import Incomplete

log = logging.getLogger("pepr_tpu_torch")

NEG = -1e30
TRANSITIONS = ("tmm", "tmi", "tmd", "tim", "tii", "tdm", "tdd")
# length buckets (factor 4, the reference's `p4`): sequences from 128,
# profiles from 64, both capped at MAX_BUCKET
SEQ_BUCKET0 = 128
HMM_BUCKET0 = 64
MAX_BUCKET = 4096


@dataclass
class ProfileHMM:
    match_logodds: np.ndarray  # (M, 20) log2(e_m(a) / bg(a))
    log_tmm: np.ndarray  # (M+1,) log2 P(M->M) (index 0 = begin)
    log_tmi: np.ndarray  # (M+1,)
    log_tmd: np.ndarray  # (M+1,)
    log_tim: np.ndarray  # (M+1,)
    log_tii: np.ndarray  # (M+1,)
    log_tdm: np.ndarray  # (M+1,)
    log_tdd: np.ndarray  # (M+1,)
    name: str = ""

    @property
    def length(self) -> int:
        return self.match_logodds.shape[0]


def build_profile_hmm(aln: np.ndarray, name: str = "",
                      pseudo: float = 1.0,
                      gap_cutoff: float = 0.5,
                      entropy_target: float = 0.59) -> ProfileHMM:
    """Build a profile from an aligned (n, L) int8 matrix.

    entropy_target: HMMER-style entropy weighting: the observed counts
    are scaled down (effective sequence number) until the mean
    per-match-column relative entropy vs the background is at most
    this many bits (HMMER3's amino-acid default ~0.59).  None disables
    it."""
    n, L = aln.shape
    bg = WAG_FREQS / WAG_FREQS.sum()
    is_gap = (aln == GAP) | (aln == PAD)
    gap_frac = is_gap.mean(axis=0)
    match_cols = np.where(gap_frac <= gap_cutoff)[0]
    M = len(match_cols)
    if M == 0:
        match_cols = np.arange(L)
        M = L

    sub = aln[:, match_cols]
    counts = np.zeros((M, N_AA))
    for a in range(N_AA):
        counts[:, a] = (sub == a).sum(axis=0)

    def logodds_for(scale: float) -> np.ndarray:
        probs = scale * counts + pseudo * bg[None, :]
        probs /= probs.sum(axis=1, keepdims=True)
        return np.log2(probs / bg[None, :])

    def mean_rel_entropy(scale: float) -> float:
        probs = scale * counts + pseudo * bg[None, :]
        probs /= probs.sum(axis=1, keepdims=True)
        return float((probs * np.log2(probs / bg[None, :])).sum(1).mean())

    scale = 1.0
    if entropy_target is not None and mean_rel_entropy(1.0) > entropy_target:
        lo, hi = 0.0, 1.0  # bisection on the count scale (monotone)
        for _ in range(30):
            mid = 0.5 * (lo + hi)
            if mean_rel_entropy(mid) > entropy_target:
                hi = mid
            else:
                lo = mid
        scale = 0.5 * (lo + hi)
    match_logodds = logodds_for(scale)

    # transition counts from the gap structure between match columns
    tmm = np.full(M + 1, 0.9)
    tmi = np.full(M + 1, 0.05)
    tmd = np.full(M + 1, 0.05)
    tim = np.full(M + 1, 0.5)
    tii = np.full(M + 1, 0.5)
    tdm = np.full(M + 1, 0.5)
    tdd = np.full(M + 1, 0.5)
    # deletions: gap fraction at each match column
    tmd_v = np.clip(is_gap[:, match_cols].mean(axis=0), 0.02, 0.6)
    # insertions: residue density in the run between consecutive match
    # columns (prefix sums over per-column non-gap counts)
    starts = match_cols + 1
    ends = np.append(match_cols[1:], L)
    nongap_col = np.concatenate(
        [[0], np.cumsum((~is_gap).sum(axis=0))])
    region_sum = nongap_col[ends] - nongap_col[starts]
    region_len = ends - starts
    ins_frac = np.where(region_len > 0,
                        region_sum / np.maximum(n * region_len, 1), 0.0)
    tmi_v = np.where(region_len > 0, np.clip(ins_frac, 0.02, 0.5), 0.02)
    tmm_v = np.maximum(1.0 - tmi_v - tmd_v, 0.1)
    s = tmm_v + tmi_v + tmd_v
    tmm[:M] = tmm_v / s
    tmi[:M] = tmi_v / s
    tmd[:M] = tmd_v / s

    def lg(x):
        return np.log2(np.maximum(x, 1e-10))

    return ProfileHMM(match_logodds.astype(np.float32), lg(tmm), lg(tmi),
                      lg(tmd), lg(tim), lg(tii), lg(tdm), lg(tdd), name)


def pack_profiles(hmms: list[ProfileHMM], length: int | None = None):
    """Stack profiles into padded arrays: emissions (H, 20, Mpad)
    (profile length minor, the reference's layout), a dict of the seven
    transitions as (H, Mpad+1) float32 (padding -20), and the (H,)
    lengths."""
    ms = [h.length for h in hmms]
    mpad = int(length or 2 ** int(np.ceil(np.log2(max(max(ms), 2)))))
    H = len(hmms)
    emit = np.full((H, N_AA, mpad), -20.0, dtype=np.float32)
    fields = {k: np.full((H, mpad + 1), -20.0, dtype=np.float32)
              for k in TRANSITIONS}
    for i, h in enumerate(hmms):
        m = min(h.length, mpad)
        emit[i, :, :m] = h.match_logodds[:m].T
        for k, arr in (("tmm", h.log_tmm), ("tmi", h.log_tmi),
                       ("tmd", h.log_tmd), ("tim", h.log_tim),
                       ("tii", h.log_tii), ("tdm", h.log_tdm),
                       ("tdd", h.log_tdd)):
            fields[k][i, : m + 1] = arr[: m + 1]
    return emit, fields, np.array(ms, dtype=np.int32)


# -- the plain version of the DP ----------------------------------------

def _shift(v: torch.Tensor, t: int, fill: float) -> torch.Tensor:
    """v[..., k] -> v[..., k-t], `fill` at k < t."""
    return torch.nn.functional.pad(v[..., :-t], (t, 0), value=fill)


def _shift1(v: torch.Tensor) -> torch.Tensor:
    """v[..., k] -> v[..., k-1], NEG at k = 0."""
    return _shift(v, 1, NEG)


def _semiring_linear_scan(s: torch.Tensor, d: torch.Tensor,
                          op=torch.maximum) -> torch.Tensor:
    """x_k = op(s_k, x_{k-1} + d_{k-1}) along the last axis (x_{-1} =
    -inf) as the reference's Kogge-Stone doubling in the (op, +)
    semiring: composition of (a1, s1) then (a2, s2) is
    (a1 + a2, op(s2, s1 + a2))."""
    a = _shift1(d)
    m = s.shape[-1]
    t = 1
    while t < m:
        a_l = _shift(a, t, 0.0)
        s_l = _shift(s, t, NEG)
        s = op(s, s_l + a)
        a = a + a_l
        t *= 2
    return s


def _lse2(x: torch.Tensor, dim: int) -> torch.Tensor:
    """log2-sum-exp2 reduction (safe at NEG sentinels)."""
    m = x.max(dim=dim, keepdim=True).values
    out = m + torch.log2(torch.exp2(x - m).sum(dim=dim, keepdim=True))
    return out.squeeze(dim)


def viterbi_segment(seq_codes: torch.Tensor, pos0: int,
                    seq_lens: torch.Tensor, emit: torch.Tensor, tmm, tmi,
                    tmd, tim, tii, tdm, tdd, m_lens: torch.Tensor, vm0, vi0,
                    vd0, total0, forward: bool = False):
    """One sequence-axis segment of the Plan7 local DP (Viterbi, or
    Forward with `forward=True`): seq_codes (B, Lseg) from absolute
    position `pos0`, carrying (vm, vi, vd, total) in and out."""
    B, L = seq_codes.shape
    M = emit.shape[2]
    entry = -torch.log2(torch.clamp(m_lens.to(torch.float32), min=1.0))
    k_valid = torch.arange(M, device=emit.device)[None, :] < m_lens[:, None]
    # torch.logaddexp2 is jnp.logaddexp2's max(a, b) + log1p(exp2(-|a -
    # b|)) / ln 2 in one op (no infinities reach it: the sentinel NEG is
    # finite)
    op = torch.logaddexp2 if forward else torch.maximum

    # transitions are loop-invariant: shifted once
    tmm_s = _shift1(tmm[:, :M])
    tim_s = _shift1(tim[:, :M])
    tdm_s = _shift1(tdm[:, :M])
    tmd_m = tmd[:, :M]
    tmi_m = tmi[:, :M]
    tii_m = tii[:, :M]
    tdd_m = tdd[:, :M]
    entry_b = entry[:, None].expand(B, M)

    vm, vi, vd, total = vm0, vi0, vd0, total0
    codes = seq_codes.to(torch.int64)
    for j in range(L):
        c = codes[:, j]
        emits = (c >= 0) & (c < N_AA)
        e = emit.gather(1, c.clamp(0, N_AA - 1)[:, None, None]
                        .expand(B, 1, M))[:, 0]
        e = torch.where(emits[:, None], e, 0.0)
        sh = _shift1(torch.stack([vm, vi, vd], dim=1))
        best_in = op(op(sh[:, 0] + tmm_s, sh[:, 1] + tim_s),
                     op(sh[:, 2] + tdm_s, entry_b))
        new_vm = torch.where(k_valid, e + best_in, NEG)
        new_vi = op(vm + tmi_m, vi + tii_m)
        # delete chain within this position: d_k = op(m_{k-1} + tmd_{k-1},
        # d_{k-1} + tdd_{k-1})
        s_term = _shift1(new_vm + tmd_m)
        new_vd = _semiring_linear_scan(s_term, tdd_m, op=op)
        if forward:
            new_total = torch.logaddexp2(total, _lse2(new_vm, dim=1))
        else:
            new_total = torch.maximum(total, new_vm.max(dim=1).values)
        live = (pos0 + j) < seq_lens
        vm = torch.where(live[:, None], new_vm, vm)
        vi = torch.where(live[:, None], new_vi, vi)
        vd = torch.where(live[:, None], new_vd, vd)
        total = torch.where(live, new_total, total)
    return vm, vi, vd, total


def viterbi_score_batch(seq_codes: torch.Tensor, seq_lens: torch.Tensor,
                        emit: torch.Tensor, tmm, tmi, tmd, tim, tii, tdm,
                        tdd, m_lens: torch.Tensor, segment: int = 512,
                        forward: bool = False) -> torch.Tensor:
    """Plan7 local Viterbi (or Forward) scores in bits for B (sequence,
    profile) pairs, the plain version: seq_codes (B, L) int8, emit
    (B, 20, M) log-odds, transitions (B, M+1) log2.  Free uniform entry
    into any match state (log2(1/M)) and free exit from any.  Runs as
    `segment`-column pieces with the carry kept, as the reference does
    (identical scores).  Positions past every sequence's length change
    nothing (the `live` mask), so the loop stops at the longest."""
    B, L = seq_codes.shape
    M = emit.shape[2]
    L = min(L, int(seq_lens.max())) if B else 0
    kw = dict(dtype=torch.float32, device=emit.device)
    vm = torch.full((B, M), NEG, **kw)
    vi = torch.full((B, M), NEG, **kw)
    vd = torch.full((B, M), NEG, **kw)
    total = torch.full((B,), NEG, **kw)
    with torch.no_grad():
        for s0 in range(0, L, segment):
            vm, vi, vd, total = viterbi_segment(
                seq_codes[:, s0:s0 + segment], s0, seq_lens, emit, tmm, tmi,
                tmd, tim, tii, tdm, tdd, m_lens, vm, vi, vd, total,
                forward=forward)
    return total


def gather_pairs(codes_all, lens_all, emit_all, trans_all, m_lens_all,
                 seq_idx, hmm_idx, lpad: int, mpad: int):
    """The plain version's inputs for a chunk, gathered from the packs:
    (codes (B, lpad), lens, emit (B, 20, mpad), [7 transitions
    (B, mpad+1)], m_lens)."""
    codes = codes_all[seq_idx, :lpad]
    lens = torch.clamp(lens_all[seq_idx], max=lpad)
    emit = emit_all[hmm_idx, :, :mpad]
    m_lens = torch.clamp(m_lens_all[hmm_idx], max=mpad)
    tr = [t[hmm_idx, :mpad + 1] for t in trans_all]
    return codes, lens, emit, tr, m_lens


def score_chunk(codes_all, lens_all, emit_all, trans_all, m_lens_all,
                seq_idx, hmm_idx, lpad: int, forward: bool,
                walk=None) -> torch.Tensor:
    """Raw bits (no null correction) of the pairs (seq_idx[b],
    hmm_idx[b]) from the packs: the kernel (`ops/hmm_kernel.py`) for
    CUDA tensors, on `walk`, the pack's walk pack (made here if None),
    and the plain version for CPU tensors."""
    if codes_all.is_cuda:
        from pepr_tpu_torch.ops import hmm_kernel
        if walk is None:
            walk = hmm_kernel.walk_pack(emit_all, trans_all, m_lens_all)
        return hmm_kernel.hmm_score(codes_all, lens_all, walk, seq_idx,
                                    hmm_idx, lpad, forward)
    codes, lens, emit, tr, m_lens = gather_pairs(
        codes_all, lens_all, emit_all, trans_all, m_lens_all, seq_idx,
        hmm_idx, lpad, emit_all.shape[2])
    return viterbi_score_batch(codes, lens, emit, *tr, m_lens,
                               forward=forward)


# -- batching the pairs ------------------------------------------------

def p2(x: int, lo: int) -> int:
    return int(max(lo, 2 ** int(np.ceil(np.log2(max(x, 1))))))


def p4(x: int, lo: int, hi: int = MAX_BUCKET) -> int:
    """Factor-4 length bucket from `lo`, capped at `hi`."""
    v = lo
    while v < min(x, hi):
        v *= 4
    return min(v, hi)


def eff_batch(batch_size: int, lpad: int, mpad: int) -> int:
    """Pairs per chunk of a (lpad, mpad) bucket, as the reference cuts
    them: at most `batch_size`, ~2**33 / (lpad * mpad) pairs, at least
    128, rounded down to a power of two."""
    eff = int(min(batch_size, max(128, (2 ** 33) // (lpad * mpad))))
    return 2 ** int(np.floor(np.log2(eff)))


def pack_sequences(seqs: list[np.ndarray]):
    """(N, Lmax) int8 codes, PAD-filled, Lmax a power of two >= 128, and
    the (N,) lengths (cut to Lmax)."""
    lmax = p2(max(len(s) for s in seqs), SEQ_BUCKET0)
    codes = np.full((len(seqs), lmax), PAD, dtype=np.int8)
    lens = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        n = min(len(s), lmax)
        codes[i, :n] = np.asarray(s[:n], np.int8)
        lens[i] = n
    return codes, lens


def p4_all(x: np.ndarray, lo: int, hi: int = MAX_BUCKET) -> np.ndarray:
    """`p4` of every element of x."""
    edges = [lo]
    while edges[-1] < hi:
        edges.append(edges[-1] * 4)
    edges = np.asarray(edges, np.int64)
    y = np.minimum(np.asarray(x, np.int64), hi)
    return np.minimum(edges[np.searchsorted(edges, y)], hi)


def pair_buckets(seq_lens: np.ndarray, hmm_lens: np.ndarray,
                 pairs) -> dict[tuple[int, int], np.ndarray]:
    """{(lpad, mpad): pair indices} in pair order."""
    pair_arr = np.asarray(pairs, np.int64).reshape(-1, 2)
    lp = p4_all(seq_lens[pair_arr[:, 0]], SEQ_BUCKET0)
    mp = p4_all(hmm_lens[pair_arr[:, 1]], HMM_BUCKET0)
    keys = lp * (MAX_BUCKET + 1) + mp
    return {(int(k // (MAX_BUCKET + 1)), int(k % (MAX_BUCKET + 1))):
            np.flatnonzero(keys == k) for k in np.unique(keys)}


@dataclass
class Bucket:
    """One (lpad, mpad) bucket of a pair list as `profile_score_pairs`
    scores it: its pairs (indices into the list, in list order), their
    sequence indices, their profile indices in the bucket's mpad pack,
    and launches of at most `eff` pairs each."""
    lpad: int
    mpad: int
    pairs: np.ndarray
    seq_idx: np.ndarray
    hmm_idx: np.ndarray
    eff: int

    def launches(self) -> list[slice]:
        return [slice(s0, s0 + self.eff)
                for s0 in range(0, len(self.pairs), self.eff)]

    def pending(self, done: np.ndarray) -> "Bucket":
        """The bucket's pairs not yet `done` (a mask over the pair list),
        in order, in launches of the same size."""
        keep = ~done[self.pairs]
        return replace(self, pairs=self.pairs[keep],
                       seq_idx=self.seq_idx[keep], hmm_idx=self.hmm_idx[keep])

    def real_cells(self, seq_lens: np.ndarray, m_lens: np.ndarray,
                   sel: slice = slice(None)) -> int:
        """DP cells the pairs `sel` hold inside L x M (`m_lens`: the
        pack's profile lengths)."""
        return int((np.minimum(seq_lens[self.seq_idx[sel]], self.lpad)
                    .astype(np.int64)
                    * np.minimum(m_lens[self.hmm_idx[sel]], self.mpad)).sum())


def score_plan(seq_lens: np.ndarray, hmm_lens: np.ndarray, pairs,
               batch_size: int = 4096) -> list[tuple[int, list[int],
                                                      list[Bucket]]]:
    """The reference's launches, which `profile_score_pairs` makes on the
    CPU and reports in `counts`: [(mpad, members, buckets)] by ascending
    mpad, `members` the profiles of that pack (in pack order), `buckets`
    its (lpad, mpad) buckets by ascending lpad, pairs in list order,
    launches of at most `eff` pairs."""
    pair_arr = np.asarray(pairs, np.int64).reshape(-1, 2)
    buckets = pair_buckets(seq_lens, hmm_lens, pair_arr)
    groups: dict[int, list[int]] = {}
    for hi, m in enumerate(hmm_lens):
        groups.setdefault(p4(int(m), HMM_BUCKET0), []).append(hi)
    plan = []
    for mpad in sorted(groups):
        lpads = sorted(lp for (lp, mp) in buckets if mp == mpad)
        if not lpads:
            continue
        members = groups[mpad]
        local_of = np.zeros(len(hmm_lens), np.int32)
        local_of[members] = np.arange(len(members), dtype=np.int32)
        plan.append((mpad, members, [
            Bucket(lpad, mpad, idx, pair_arr[idx, 0].astype(np.int32),
                   local_of[pair_arr[idx, 1]],
                   eff_batch(batch_size, lpad, mpad))
            for lpad in lpads for idx in [buckets[(lpad, mpad)]]]))
    return plan


def card_score_plan(seq_lens: np.ndarray, hmm_lens: np.ndarray, pairs,
                    lmax: int) -> list[tuple[int, list[int], list[Bucket]]]:
    """The card's launches: the reference's mpad packs (as `score_plan`),
    each one bucket of all its pairs at lpad = min(MAX_BUCKET, lmax), the
    sequence pack's width, sorted by real cells, longest first (ties in
    list order), in one launch.  A pair's score depends on lpad only
    through the cap, so it scores as under the reference's buckets."""
    pair_arr = np.asarray(pairs, np.int64).reshape(-1, 2)
    lpad = min(MAX_BUCKET, int(lmax))
    mp_of = p4_all(hmm_lens, HMM_BUCKET0)
    pair_mp = mp_of[pair_arr[:, 1]]
    cells = (np.minimum(seq_lens[pair_arr[:, 0]], lpad).astype(np.int64)
             * np.minimum(hmm_lens[pair_arr[:, 1]], pair_mp))
    plan = []
    for mpad in np.unique(pair_mp).tolist():
        members = np.flatnonzero(mp_of == mpad).tolist()
        local_of = np.zeros(len(hmm_lens), np.int32)
        local_of[members] = np.arange(len(members), dtype=np.int32)
        idx = np.flatnonzero(pair_mp == mpad)
        idx = idx[np.argsort(-cells[idx], kind="stable")]
        plan.append((mpad, members, [Bucket(
            lpad, mpad, idx, pair_arr[idx, 0].astype(np.int32),
            local_of[pair_arr[idx, 1]], len(idx))]))
    return plan


def card_plan(dev) -> bool:
    """Whether `profile_score_pairs` takes the card's plan and kernel on
    `dev`: a CUDA device."""
    return dev.type == "cuda"


def device_pack(hmms: list[ProfileHMM], mpad: int, dev):
    """One mpad pack on `dev`: (emit (H, 20, mpad), the seven
    transitions (H, mpad+1) in TRANSITIONS order, lengths (H,)), and
    the lengths as numpy."""
    emit, fields, m_lens = pack_profiles(hmms, mpad)
    return (torch.as_tensor(emit, device=dev),
            [torch.as_tensor(fields[k], device=dev) for k in TRANSITIONS],
            torch.as_tensor(m_lens, device=dev)), m_lens


def profile_score_pairs(seqs: list[np.ndarray], hmms: list[ProfileHMM],
                        pairs: list[tuple[int, int]],
                        batch_size: int = 4096, store=None,
                        deadline=None, ckpt_key: str | None = None,
                        algorithm: str = "forward",
                        null_per_col: float = 0.22, device=None,
                        counts: dict | None = None) -> np.ndarray:
    """Score (sequence index, hmm index) pairs; returns bits (P,).

    algorithm: "forward" (default, hmmsearch's full-sequence bit score)
    or "viterbi" (best single path).  null_per_col: bits per match
    column subtracted from every score once at the end (the reference's
    empirical null correction, which puts these bits on the HMMER
    scale).  `device`: the card unless "cpu" (`resolve_device`).
    `counts`, if given, receives the pairs by bucket and the padded and
    real DP cells.

    With `store` and `ckpt_key` the progress is saved as a mask over
    the pairs and their raw scores (at most once a minute, at the end,
    and on interruption): a pair's score does not depend on the launch
    it ran in, so the card's plan and the CPU's buckets resume one
    store.  `deadline.near(90.0)` is polled before each launch; when it
    holds, the launches made are synchronized and saved and Incomplete
    is raised."""
    if algorithm not in ("forward", "viterbi"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    forward = algorithm == "forward"
    dev = resolve_device(device)
    if not pairs:
        return np.zeros(0, np.float32)
    out = np.zeros(len(pairs), np.float32)
    done = np.zeros(len(pairs), dtype=bool)
    use_ckpt = store is not None and ckpt_key is not None
    if use_ckpt and store.has(ckpt_key):
        st = store.load(ckpt_key)
        done = st["done"]
        out[:] = st["out"]
        log.info("profile scoring resume: %d of %d pairs already done",
                 int(done.sum()), len(pairs))
    last_save = time.time()

    def save():
        if use_ckpt:
            store.save(ckpt_key, {"done": done, "out": out})

    codes_np, lens_np = pack_sequences(seqs)
    codes_all = torch.as_tensor(codes_np, device=dev)
    lens_all = torch.as_tensor(lens_np, device=dev)
    hmm_lens = np.array([h.length for h in hmms], np.int64)
    card = card_plan(dev)
    ref = None
    if counts is not None or not card:
        ref = score_plan(lens_np, hmm_lens, pairs, batch_size)
    if counts is not None:
        counts.update(pairs_by_bucket={}, padded_cells=0, real_cells=0)
        for mpad, members, buckets in ref:
            for b in buckets:
                counts["pairs_by_bucket"][f"{b.lpad}x{mpad}"] = len(b.pairs)
                counts["padded_cells"] += len(b.pairs) * b.lpad * mpad
                counts["real_cells"] += b.real_cells(lens_np,
                                                     hmm_lens[members])
    plan = card_score_plan(lens_np, hmm_lens, pairs,
                           codes_np.shape[1]) if card else ref

    for mpad, members, buckets in plan:
        # the pairs still to score, each bucket's in its order
        buckets = [b.pending(done) for b in buckets]
        buckets = [b for b in buckets if len(b.pairs)]
        if not buckets:
            continue
        pack, _ = device_pack([hmms[i] for i in members], mpad, dev)
        walk = None
        if card:
            from pepr_tpu_torch.ops.hmm_kernel import walk_pack
            walk = walk_pack(*pack)
        for b in buckets:
            t0 = time.time()
            si_all = torch.as_tensor(b.seq_idx, device=dev)
            hi_all = torch.as_tensor(b.hmm_idx, device=dev)
            res = []
            stop = False
            for sel in b.launches():
                if deadline is not None and deadline.near(90.0):
                    stop = True
                    break
                res.append(score_chunk(codes_all, lens_all, *pack,
                                       si_all[sel], hi_all[sel], b.lpad,
                                       forward, walk=walk))
            if res:
                # one host sync per bucket
                got = torch.cat(res).cpu().numpy()
                out[b.pairs[:len(got)]] = got
                done[b.pairs[:len(got)]] = True
                log.info("profile scoring bucket (%d,%d): %d pairs in %.2fs",
                         b.lpad, mpad, len(got), time.time() - t0)
            if stop:
                save()
                raise Incomplete("profile HMM scoring")
            if use_ckpt and time.time() - last_save > 60.0:
                save()
                last_save = time.time()
        del pack, walk
    save()
    # the null correction once, on the return (the store holds raw
    # kernel scores)
    if null_per_col:
        m_arr = hmm_lens[np.asarray(pairs, np.int64).reshape(-1, 2)[:, 1]]
        return out - null_per_col * m_arr.astype(np.float32)
    return out
