"""Build and load the port's CUDA kernels.

Every `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its own
library `_build/libpepr_<name>.so`, with a plain C interface loaded by
`ctypes` (no PyTorch headers, so a build takes seconds).  A library is
rebuilt when its source's hash differs from the one stored beside it.
`build()` starts one `nvcc` per source, all at once, and waits for them.
The library and its stamp are each written to a temporary file and
renamed into place, so a process never loads a half-written library or
reads a half-written stamp.  Over several ranks the node's local rank 0
builds while the others wait at a barrier
(`parallel.mesh.initialize_distributed`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
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
    with open(source_path(name), "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _up_to_date(name: str, digest: str) -> bool:
    stamp = lib_path(name) + ".sha256"
    if not (os.path.exists(lib_path(name)) and os.path.exists(stamp)):
        return False
    with open(stamp) as fh:
        return fh.read().strip() == digest


def build(names=SOURCES, force: bool = False) -> dict[str, str]:
    """Compile the named libraries that are missing or stale, one `nvcc`
    process per source, run side by side.  Returns {name: compiler
    output} for what was built."""
    todo = {n: _source_hash(n) for n in names}
    if not force:
        todo = {n: d for n, d in todo.items() if not _up_to_date(n, d)}
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    procs = {}
    for n in todo:
        tmp = f"{lib_path(n)}.{os.getpid()}.tmp"
        # output to a file, not a pipe: a full pipe would stall one
        # compiler while another is waited on
        with open(tmp + ".log", "w") as log:
            procs[n] = (tmp, subprocess.Popen(
                nvcc_command(nvcc, source_path(n), tmp), stdout=log,
                stderr=subprocess.STDOUT))
    logs, failed = {}, []
    for n, (tmp, proc) in procs.items():
        proc.wait(timeout=900)
        with open(tmp + ".log") as log:
            logs[n] = log.read()
        os.remove(tmp + ".log")
        if proc.returncode != 0:
            failed.append(n)
            continue
        os.replace(tmp, lib_path(n))
        with open(tmp + ".sha256", "w") as fh:
            fh.write(todo[n] + "\n")
        os.replace(tmp + ".sha256", lib_path(n) + ".sha256")
    if failed:
        raise RuntimeError("nvcc failed to build "
                           + ", ".join(f"csrc/{n}.cu" for n in failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str, argtypes: dict, restypes: dict) -> ctypes.CDLL:
    """Build `name` if needed, load it and declare its C functions."""
    build((name,))
    lib = ctypes.CDLL(lib_path(name))
    for fn_name, args in argtypes.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = args
        fn.restype = restypes[fn_name]
    return lib
