"""FASTA ingest: protein files -> int8 code arrays + taxon registry.

Reproduces the reference's data model (FastaSequenceFile.java:46-181:
line-indexed FASTA with ID->index map and taxon extraction;
FastaUtilities.java:25-114: taxon name = last [...]-bracketed field of
the title, pipe-suffix stripped, forbidden characters -> underscore) as
a host-side loader that produces padded device-ready arrays.  The JAX
package's native C++ scanner is not carried over: this is its numpy
path.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

import numpy as np

from pepr_tpu_torch.alphabet import PAD, encode, decode

_FORBIDDEN = re.compile(r"[ ():,\[\]]")


def _sanitize(name: str) -> str:
    """Forbidden chars -> '_', collapsing doubles as the reference does
    (FastaUtilities.java:42-45 applies replace then collapses '__')."""
    out = _FORBIDDEN.sub("_", name)
    while "__" in out:
        out = out.replace("__", "_")
    return out


def taxon_from_title(title: str, strip_pipe_suffix: bool = True) -> str:
    """Taxon = contents of the last balanced [...] in the title; falls
    back to the whole title.  FastaUtilities.java:51-114 semantics."""
    t = title[1:] if title.startswith(">") else title
    last_close = t.rfind("]")
    r = None
    if last_close > 0:
        ignore = 0
        for i in range(last_close - 1, -1, -1):
            ch = t[i]
            if ch == "]":
                ignore += 1
            elif ch == "[":
                if ignore == 0:
                    r = t[i + 1:last_close]
                    break
                ignore -= 1
    if r is None:
        r = t
    if strip_pipe_suffix:
        pipe = r.find("|")
        if pipe > -1:
            r = r[:pipe].strip()
    else:
        r = r.replace("|", "@")
    return _sanitize(r)


@dataclass
class SequenceSet:
    """A set of protein sequences (one genome file or one homolog group).

    In-memory counterpart of FastaSequenceFile / FastaSequenceSetImpl.
    """

    name: str
    titles: list[str]
    seqs: list[np.ndarray]  # int8 code arrays
    source_path: str | None = None
    _taxa: list[str] | None = field(default=None, repr=False)
    _id_index: dict[str, int] | None = field(default=None, repr=False)

    def __len__(self) -> int:
        return len(self.seqs)

    @property
    def ids(self) -> list[str]:
        """First whitespace-delimited token of each title (the ID blast
        rows are keyed by)."""
        return [t.split()[0] if t.split() else t for t in self.titles]

    @property
    def taxa(self) -> list[str]:
        if self._taxa is None:
            self._taxa = [taxon_from_title(t) for t in self.titles]
        return self._taxa

    def distinct_taxa(self) -> list[str]:
        seen: dict[str, None] = {}
        for t in self.taxa:
            seen.setdefault(t, None)
        return list(seen)

    @property
    def taxon(self) -> str:
        """Single taxon of a genome file (first sequence's taxon, the
        reference's FastaSequenceFile.getTaxa()[0] convention)."""
        return self.taxa[0] if self.titles else self.name

    def index_of_id(self, seq_id: str) -> int:
        if self._id_index is None:
            self._id_index = {i: k for k, i in enumerate(self.ids)}
        return self._id_index[seq_id]

    def lengths(self) -> np.ndarray:
        return np.array([len(s) for s in self.seqs], dtype=np.int32)

    def total_residues(self) -> int:
        return int(self.lengths().sum())

    def subset(self, indices, name: str | None = None) -> "SequenceSet":
        idx = list(indices)
        return SequenceSet(name or self.name,
                           [self.titles[i] for i in idx],
                           [self.seqs[i] for i in idx],
                           source_path=self.source_path)

    def sequence_strings(self) -> list[str]:
        return [decode(s) for s in self.seqs]


def read_fasta(path: str, name: str | None = None,
               alphabet: str = "aa") -> SequenceSet:
    """alphabet="nt" encodes with the nucleotide LUT (ACGT=0-3) for
    the blastn-equivalent pipeline (BlastRunner.java:603-706 role)."""
    stem = os.path.basename(path)
    for suffix in (".faa", ".fna", ".fasta", ".fa"):
        if stem.endswith(suffix):
            stem = stem[: -len(suffix)]
            break
    titles: list[str] = []
    chunks: list[list[str]] = []
    with open(path, "r") as fh:
        cur: list[str] | None = None
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                titles.append(line[1:].strip())
                cur = []
                chunks.append(cur)
            elif cur is not None:
                cur.append(line)
    if alphabet == "nt":
        from pepr_tpu_torch.alphabet import encode_nt
        seqs = [encode_nt("".join(c)) for c in chunks]
    else:
        seqs = [encode("".join(c)) for c in chunks]
    return SequenceSet(name or stem, titles, seqs, source_path=path)


def write_fasta(path: str, sset: SequenceSet, width: int = 60,
                max_title_len: int | None = None) -> None:
    with open(path, "w") as fh:
        for title, seq in zip(sset.titles, sset.seqs):
            if max_title_len is not None:
                title = title[:max_title_len]
            fh.write(f">{title}\n")
            s = decode(seq, pad_char="")
            for i in range(0, len(s), width):
                fh.write(s[i:i + width] + "\n")


def pack_padded(seqs: list[np.ndarray], length: int | None = None,
                multiple: int = 128) -> tuple[np.ndarray, np.ndarray]:
    """Stack ragged int8 sequences into a PAD-filled (n, L) array with L
    rounded up to `multiple`.  Returns (codes,
    lengths)."""
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    lmax = int(length if length is not None else (lens.max() if len(lens) else 0))
    lmax = ((lmax + multiple - 1) // multiple) * multiple if lmax else multiple
    out = np.full((len(seqs), lmax), PAD, dtype=np.int8)
    for i, s in enumerate(seqs):
        n = min(len(s), lmax)
        out[i, :n] = s[:n]
    return out, lens
