"""Alignment format I/O: fasta / phylip / clustal / nexus.

Parity with the reference's SequenceAlignmentParser
(SequenceAlignmentParser.java:22-152) and SequenceAlignment's
serializers (SequenceAlignment.java:405-599: fasta, clustal,
phylip-by-taxon and by-name).  A copy of `pepr_tpu/io/alignio.py` on
the port's alphabet and `Alignment`.
"""

from __future__ import annotations

import re

import numpy as np

from pepr_tpu_torch.alphabet import decode, encode
from pepr_tpu_torch.models.msa import Alignment


def _to_alignment(names: list[str], rows: list[str], name: str) -> Alignment:
    mat = np.stack([encode(r) for r in rows])
    return Alignment(name, list(names), mat)


def parse_fasta_alignment(text: str, name: str = "aln") -> Alignment:
    names, rows = [], []
    cur: list[str] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            names.append(line[1:].split()[0])
            cur = []
            rows.append(cur)
        else:
            cur.append(line)
    return _to_alignment(names, ["".join(r) for r in rows], name)


def parse_phylip(text: str, name: str = "aln") -> Alignment:
    """Sequential or interleaved phylip
    (SequenceAlignmentParser.java:110-131)."""
    lines = [l for l in text.splitlines() if l.strip()]
    n, L = (int(x) for x in lines[0].split()[:2])
    names: list[str] = []
    seqs: list[str] = [""] * n
    i = 0
    for line in lines[1:]:
        row = i % n
        if len(names) < n:
            parts = line.split(None, 1)
            names.append(parts[0])
            seqs[row] += re.sub(r"\s", "", parts[1]) if len(parts) > 1 else ""
        else:
            seqs[row] += re.sub(r"\s", "", line)
        i += 1
    seqs = [s[:L] for s in seqs]
    return _to_alignment(names, seqs, name)


def parse_clustal(text: str, name: str = "aln") -> Alignment:
    """Clustal format (SequenceAlignmentParser.java:71-108)."""
    order: list[str] = []
    chunks: dict[str, list[str]] = {}
    for line in text.splitlines():
        if not line.strip() or line.startswith(("CLUSTAL", "MUSCLE")):
            continue
        if line[:1].isspace():  # conservation line
            continue
        parts = line.split()
        if len(parts) < 2:
            continue
        nm, seq = parts[0], parts[1]
        if not re.fullmatch(r"[A-Za-z\-.*?]+", seq):
            continue
        if nm not in chunks:
            order.append(nm)
            chunks[nm] = []
        chunks[nm].append(seq)
    return _to_alignment(order, ["".join(chunks[nm]) for nm in order], name)


def parse_nexus(text: str, name: str = "aln") -> Alignment:
    """Minimal NEXUS data-matrix parser
    (SequenceAlignmentParser.java:22-69)."""
    m = re.search(r"matrix(.*?);", text, re.IGNORECASE | re.DOTALL)
    if not m:
        raise ValueError("no matrix block in nexus input")
    order: list[str] = []
    chunks: dict[str, list[str]] = {}
    for line in m.group(1).splitlines():
        line = line.strip()
        if not line or line.startswith("["):
            continue
        parts = line.split()
        if len(parts) < 2:
            continue
        nm = parts[0].strip("'\"")
        seq = "".join(parts[1:])
        if nm not in chunks:
            order.append(nm)
            chunks[nm] = []
        chunks[nm].append(seq)
    return _to_alignment(order, ["".join(chunks[nm]) for nm in order], name)


def parse_alignment(text: str, name: str = "aln") -> Alignment:
    """Format sniffing like the reference's dispatch."""
    head = text.lstrip()[:10].lower()
    if head.startswith(">"):
        return parse_fasta_alignment(text, name)
    if head.startswith("#nexus"):
        return parse_nexus(text, name)
    if head.startswith(("clustal", "muscle")):
        return parse_clustal(text, name)
    return parse_phylip(text, name)


# -- writers ---------------------------------------------------------------

def write_fasta_alignment(aln: Alignment, width: int = 60) -> str:
    out = []
    for nm, row in zip(aln.taxa, aln.mat):
        out.append(">" + nm)
        s = decode(row, pad_char="-").replace("?", "-")
        for i in range(0, len(s), width):
            out.append(s[i:i + width])
    return "\n".join(out) + "\n"


def write_phylip(aln: Alignment, name_width: int = 10) -> str:
    """Sequential phylip with padded names
    (SequenceAlignment.java:489-527)."""
    out = [f" {aln.n_seqs} {aln.length}"]
    used: set[str] = set()
    for nm, row in zip(aln.taxa, aln.mat):
        short = re.sub(r"[^A-Za-z0-9_.|-]", "_", nm)[:name_width]
        base, k = short, 1
        while short in used:
            suffix = str(k)
            short = base[: name_width - len(suffix)] + suffix
            k += 1
        used.add(short)
        out.append(short.ljust(name_width) + decode(row, pad_char="-"))
    return "\n".join(out) + "\n"


def write_clustal(aln: Alignment, width: int = 60) -> str:
    out = ["CLUSTAL W formatted alignment (pepr_tpu)", ""]
    rows = [decode(r, pad_char="-") for r in aln.mat]
    name_w = max((len(t) for t in aln.taxa), default=0) + 2
    for start in range(0, aln.length, width):
        for nm, row in zip(aln.taxa, rows):
            out.append(nm.ljust(name_w) + row[start:start + width])
        out.append("")
    return "\n".join(out) + "\n"


def write_nexus(aln: Alignment) -> str:
    rows = [decode(r, pad_char="-") for r in aln.mat]
    out = ["#NEXUS", "begin data;",
           f"  dimensions ntax={aln.n_seqs} nchar={aln.length};",
           "  format datatype=protein gap=- missing=?;", "  matrix"]
    for nm, row in zip(aln.taxa, rows):
        out.append(f"  '{nm}' {row}")
    out += ["  ;", "end;"]
    return "\n".join(out) + "\n"
