"""Build and load the port's CUDA kernels.

Every `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its own
library `_build/libpepr_<name>.so`, with a plain C interface loaded by
`ctypes` (no PyTorch headers, so a build takes seconds).  A library is
rebuilt when its source's hash differs from the one stored beside it.
`build()` starts one `nvcc` per source, all at once, and waits for them
(`utils/libbuild.py`, which the native host library's `g++` build
shares: the library and its stamp are each written to a temporary file
and renamed into place, so a process never loads a half-written library
or reads a half-written stamp).  Over several ranks the node's local rank 0
builds while the others wait at a barrier
(`parallel.mesh.initialize_distributed`).
"""

from __future__ import annotations

import ctypes
import os
import shutil

from pepr_tpu_torch.utils.libbuild import (BUILD_DIR, compile_libraries,
                                           file_digest, up_to_date)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
SOURCES = ("pruning", "sw", "hmm")


def source_path(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"libpepr_{name}.so")


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, then /usr/local/cuda/bin, then PATH."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda/bin, "
                           "PATH); the CUDA kernels cannot be built")
    return found


def nvcc_command(nvcc: str, source: str, out_path: str) -> list[str]:
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", out_path, source]


def _source_hash(name: str) -> str:
    return file_digest(source_path(name))


def build(names=SOURCES, force: bool = False) -> dict[str, str]:
    """Compile the named libraries that are missing or stale, one `nvcc`
    process per source, run side by side.  Returns {name: compiler
    output} for what was built."""
    todo = {n: _source_hash(n) for n in names}
    if not force:
        todo = {n: d for n, d in todo.items()
                if not up_to_date(lib_path(n), d)}
    if not todo:
        return {}
    nvcc = find_nvcc()
    return compile_libraries({
        n: (lambda out, n=n: nvcc_command(nvcc, source_path(n), out),
            lib_path(n), d, f"csrc/{n}.cu")
        for n, d in todo.items()})


def load(name: str, argtypes: dict, restypes: dict) -> ctypes.CDLL:
    """Build `name` if needed, load it and declare its C functions."""
    build((name,))
    lib = ctypes.CDLL(lib_path(name))
    for fn_name, args in argtypes.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = args
        fn.restype = restypes[fn_name]
    return lib
