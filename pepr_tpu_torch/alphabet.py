"""Amino-acid alphabet and integer encodings.

The whole framework represents sequences as int8 arrays.  Codes 0-19 are
the 20 standard amino acids in BLOSUM/WAG order (ARNDCQEGHILKMFPSTWYV),
followed by the ambiguity codes B/Z/X, the gap symbol, and a padding
sentinel used to length-pad batched device arrays.

Reference behavior being reproduced: the int encoding role of
AlignmentUtilities.java:174-342 (reference assigns A=0..GAP=23; we keep
our own canonical order and map ambiguity codes explicitly).
"""

from __future__ import annotations

import numpy as np

AA_ORDER = "ARNDCQEGHILKMFPSTWYV"
B, Z, X, GAP, PAD = 20, 21, 22, 23, 24
N_AA = 20  # standard amino acids
N_CODES = 25  # including B/Z/X/GAP/PAD

_CHAR_TO_CODE = {c: i for i, c in enumerate(AA_ORDER)}
_CHAR_TO_CODE.update({"B": B, "Z": Z, "X": X, "-": GAP, ".": GAP, "*": X,
                      "U": X, "O": X, "J": X, "?": GAP})

CODE_TO_CHAR = np.array(list(AA_ORDER + "BZX-") + ["?"], dtype="U1")

# 256-entry lookup table: ASCII byte -> code (unknown letters -> X).
ENCODE_LUT = np.full(256, X, dtype=np.int8)
for _c, _i in _CHAR_TO_CODE.items():
    ENCODE_LUT[ord(_c)] = _i
    ENCODE_LUT[ord(_c.lower())] = _i
ENCODE_LUT[ord("-")] = GAP
ENCODE_LUT[ord(".")] = GAP
ENCODE_LUT[ord("?")] = GAP


def encode(seq: str | bytes) -> np.ndarray:
    """Encode an amino-acid string to an int8 code array."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return ENCODE_LUT[raw]


def decode(codes: np.ndarray, pad_char: str = "") -> str:
    """Decode an int8 code array back to a string (PAD codes dropped by
    default, or rendered as `pad_char`)."""
    codes = np.asarray(codes)
    out = []
    for c in codes:
        if c == PAD:
            if pad_char:
                out.append(pad_char)
        elif 0 <= c < len(CODE_TO_CHAR):
            out.append(str(CODE_TO_CHAR[c]))
        else:
            out.append("X")
    return "".join(out)


# -- nucleotide alphabet (FastTree -nt mode support,
# FastTreeRunner.java:67-77; NT encodings of AlignmentUtilities.java:
# 174-342).  NT codes reuse the int8 convention: 0-3 = ACGT, IUPAC
# ambiguity codes -> X, gaps -> GAP, so nucleotide data rides the same
# kernels (dead protein states are masked by the model's frequencies).

NT_ORDER = "ACGT"
N_NT = 4

NT_ENCODE_LUT = np.full(256, X, dtype=np.int8)
for _i, _c in enumerate(NT_ORDER):
    NT_ENCODE_LUT[ord(_c)] = _i
    NT_ENCODE_LUT[ord(_c.lower())] = _i
NT_ENCODE_LUT[ord("U")] = NT_ENCODE_LUT[ord("u")] = 3  # RNA
for _c in "-.?":
    NT_ENCODE_LUT[ord(_c)] = GAP


def encode_nt(seq: str | bytes) -> np.ndarray:
    """Encode a nucleotide string (IUPAC ambiguity codes -> X)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return NT_ENCODE_LUT[raw]


def decode_nt(codes: np.ndarray) -> str:
    out = []
    for c in np.asarray(codes):
        if c < N_NT:
            out.append(NT_ORDER[c])
        elif c == GAP:
            out.append("-")
        elif c == PAD:
            continue
        else:
            out.append("N")
    return "".join(out)


def map_alignment_gaps_to_nt(aligned_aa: str, unaligned_nt: str) -> str:
    """Project an aligned amino-acid row onto its coding sequence: each
    AA gap becomes '---', each residue consumes the next codon
    (AlignmentUtilities.mapAlignmentGapsToNTSeq, :447-469)."""
    out = []
    k = 0
    for ch in aligned_aa:
        if ch in "-.?":
            out.append("---")
        else:
            out.append(unaligned_nt[k:k + 3])
            k += 3
    return "".join(out)
