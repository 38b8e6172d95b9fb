"""The port's native host library (`fastio.cpp`): the FASTA scanner,
the hashed k-mer counter and union-find, bound with `ctypes`.

`library()` builds `fastio.cpp` with `g++ -O3 -shared -fPIC` into the
git-ignored `_build/libpepr_fastio.so` at first use, and again whenever
the source's hash differs from the stamp beside the library
(`utils/libbuild.py`, shared with the CUDA kernels' build).  A failed
build raises RuntimeError with the compiler's output; nothing falls
back, so the CPU and the card's host run the same code.  Over several
ranks the node's local rank 0 builds it
(`parallel.mesh.initialize_distributed`).

`io/fasta.read_fasta` (protein alphabet), `ops/kmer_filter.kmer_profiles`
and `ops/mcl.connected_components` call these functions, as the JAX
package calls its own copy; their numpy bodies stay beside them as
`*_reference`.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from pepr_tpu_torch.alphabet import ENCODE_LUT, N_AA
from pepr_tpu_torch.utils.libbuild import (BUILD_DIR, compile_libraries,
                                           file_digest, up_to_date)

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fastio.cpp")
COMPILER = "g++"
# the JAX package's flags; no -march=native, so every host computes the
# same bits
FLAGS = ("-O3", "-shared", "-fPIC")

_lib = None


def lib_path() -> str:
    return os.path.join(BUILD_DIR, "libpepr_fastio.so")


def gxx_command(compiler: str, source: str, out_path: str) -> list[str]:
    return [compiler, *FLAGS, source, "-o", out_path]


def build(force: bool = False) -> dict[str, str]:
    """Compile the library if it is missing or stale.  Returns {"fastio":
    compiler output} when it was built, {} otherwise."""
    digest = file_digest(SOURCE)
    if not force and up_to_date(lib_path(), digest):
        return {}
    return compile_libraries({"fastio": (
        lambda out: gxx_command(COMPILER, SOURCE, out), lib_path(), digest,
        "pepr_tpu_torch/native/fastio.cpp")}, timeout=300.0)


def library() -> ctypes.CDLL:
    """Build if needed, load once and declare the C functions."""
    global _lib
    if _lib is not None:
        return _lib
    build()
    lib = ctypes.CDLL(lib_path())
    i8 = np.ctypeslib.ndpointer(np.int8, flags="C")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C")
    lib.fasta_stats.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    lib.fasta_stats.restype = ctypes.c_int
    lib.fasta_parse.argtypes = [
        ctypes.c_char_p, i8, i8, i64,
        np.ctypeslib.ndpointer(np.uint8, flags="C"), i64, ctypes.c_int64]
    lib.fasta_parse.restype = ctypes.c_int
    lib.kmer_profiles.argtypes = [
        i8, i64, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, np.ctypeslib.ndpointer(np.float32, flags="C")]
    lib.kmer_profiles.restype = None
    lib.connected_components.argtypes = [ctypes.c_int64, i64, i64,
                                         ctypes.c_int64, i64]
    lib.connected_components.restype = None
    _lib = lib
    return lib


def native_read_fasta(path: str) -> tuple[list[str], list[np.ndarray]]:
    """(titles, int8 code arrays) of a protein FASTA file.  A record
    opens at a '>' that starts a line; bytes up to ' ' inside sequence
    lines are dropped; titles are stripped."""
    lib = library()
    n = ctypes.c_int64()
    residues = ctypes.c_int64()
    tbytes = ctypes.c_int64()
    bpath = os.fsencode(path)
    if lib.fasta_stats(bpath, ctypes.byref(n), ctypes.byref(residues),
                       ctypes.byref(tbytes)) != 0:
        raise FileNotFoundError(f"cannot read FASTA file {path!r}")
    if n.value == 0:
        return [], []
    codes = np.empty(residues.value, dtype=np.int8)
    seq_off = np.zeros(n.value + 1, dtype=np.int64)
    titles_buf = np.zeros(tbytes.value + 1, dtype=np.uint8)
    title_off = np.zeros(n.value, dtype=np.int64)
    got = lib.fasta_parse(bpath, ENCODE_LUT, codes, seq_off, titles_buf,
                          title_off, n.value)
    if got != n.value:
        raise RuntimeError(f"{path!r} changed while it was read "
                           f"({got} records, {n.value} counted)")
    raw = titles_buf.tobytes()
    titles = []
    for i in range(n.value):
        start = int(title_off[i])
        end = raw.index(b"\0", start)
        titles.append(raw[start:end].decode("utf-8", "replace").strip())
    return titles, [codes[seq_off[i]:seq_off[i + 1]] for i in range(n.value)]


def native_kmer_profiles(seqs, k: int, dim: int, clip: int) -> np.ndarray:
    """Clipped, L2-normalised hashed k-mer count profiles, (n, dim)
    float32; the norm is taken in float64 and multiplied."""
    lib = library()
    n = len(seqs)
    offsets = np.zeros(n + 1, dtype=np.int64)
    for i, s in enumerate(seqs):
        offsets[i + 1] = offsets[i] + len(s)
    cat = np.concatenate([np.asarray(s, np.int8) for s in seqs]) \
        if n and offsets[-1] else np.zeros(1, np.int8)
    out = np.zeros((n, dim), dtype=np.float32)
    lib.kmer_profiles(np.ascontiguousarray(cat), offsets, n, k, dim, clip,
                      N_AA, out)
    return out


def native_connected_components(n: int, ei, ej) -> np.ndarray:
    """Each node's component root (union-find, path compression, the
    first endpoint's root kept on a union)."""
    lib = library()
    ei = np.ascontiguousarray(np.asarray(ei, dtype=np.int64))
    ej = np.ascontiguousarray(np.asarray(ej, dtype=np.int64))
    comp = np.zeros(n, dtype=np.int64)
    lib.connected_components(n, ei, ej, len(ei), comp)
    return comp
