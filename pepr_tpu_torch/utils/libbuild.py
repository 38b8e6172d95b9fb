"""Build shared libraries from the sources in the checkout, once per
source version, for the CUDA kernels (`ops/_cuda.py`, `nvcc`) and the
native host library (`native/`, `g++`).

A library is stale when the SHA-256 of its source differs from the
stamp written beside it (`<library>.sha256`).  `compile_libraries`
starts one compiler process per library, all at once, each writing to
a temporary file named after the process, and waits for them; a
library and then its stamp are renamed into place, so a process never
loads a half-written library or reads a half-written stamp, and ranks
that build the same library at once do not corrupt it.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

# the git-ignored directory every library is built into
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")


def file_digest(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def up_to_date(lib: str, digest: str) -> bool:
    stamp = lib + ".sha256"
    if not (os.path.exists(lib) and os.path.exists(stamp)):
        return False
    with open(stamp) as fh:
        return fh.read().strip() == digest


def compile_libraries(jobs: dict, timeout: float = 900.0) -> dict[str, str]:
    """Build every job side by side.  `jobs` maps a name to (command,
    library, digest, label): `command(out_path)` is the compiler's argv
    writing `out_path`, `label` names the source in an error.  Returns
    {name: compiler output}; raises RuntimeError with the output of
    every compiler that failed."""
    procs = {}
    for n, (command, lib, _, _) in jobs.items():
        os.makedirs(os.path.dirname(lib), exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        argv = command(tmp)
        # output to a file, not a pipe: a full pipe would stall one
        # compiler while another is waited on
        with open(tmp + ".log", "w") as log:
            try:
                proc = subprocess.Popen(argv, stdout=log,
                                        stderr=subprocess.STDOUT)
            except OSError as e:
                log.write(f"{e}\n")
                proc = None
        procs[n] = (tmp, argv, proc)
    logs, failed = {}, []
    for n, (tmp, _, proc) in procs.items():
        if proc is not None:
            proc.wait(timeout=timeout)
        with open(tmp + ".log") as log:
            logs[n] = log.read()
        os.remove(tmp + ".log")
        if proc is None or proc.returncode != 0 or not os.path.exists(tmp):
            failed.append(n)
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        _, lib, digest, _ = jobs[n]
        os.replace(tmp, lib)
        with open(tmp + ".sha256", "w") as fh:
            fh.write(digest + "\n")
        os.replace(tmp + ".sha256", lib + ".sha256")
    if failed:
        compiler = os.path.basename(procs[failed[0]][1][0])
        raise RuntimeError(
            f"{compiler} failed to build "
            + ", ".join(jobs[n][3] for n in failed) + ":\n"
            + "\n".join(logs[n] for n in failed))
    return logs
