"""Checkpoint/resume and the soft time budget for pipeline runs (PyTorch
port of `pepr_tpu/pipeline/checkpoint.py`).

Every expensive stage persists its result in a run directory, so a run
can be resumed after an interruption and a long run can execute as a
sequence of bounded slices (`Deadline`): stage 1 (homology search, MCL,
the HMM enhancer), alignments, the Gamma shape, the full tree, each
support replicate, and each refinement sub-run (its own store under
`sub{round}`).  The store keys are the JAX package's.

A store holds host objects only: numpy arrays, Newick strings, Python
numbers and the port's host dataclasses, never a tensor or a device, so
a store written on the card opens on the CPU and the other way round.
The device is not part of the fingerprint.

Over several ranks (`parallel.mesh`) every rank runs the same stages
and reads the store, and only rank 0 writes it; a deadline answers
with rank 0's clock on every rank, so that all ranks stop at the same
poll.

The deadline margins the stages poll with (`near(90.0)` before a
kernel launch, `near(60.0)` in the support replicates' rounds) are the
JAX package's, which were set for a remote TPU worker's in-flight
window; on one local card they are generous, and they stay as they are.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import time

from pepr_tpu_torch.parallel.mesh import barrier, is_writer, rank0_value

# Bump when a kernel or stage changes in a way that makes earlier
# checkpointed results stale.  The tag differs from the JAX package's
# ("v3"), so a store that package stamped (pickles of its own classes)
# is refused by fingerprint before anything in it is unpickled.
CKPT_VERSION = "torch-v1"


def config_fingerprint(*objs) -> str:
    """Stable fingerprint of a run configuration: CKPT_VERSION plus the
    repr of each config object (dataclass reprs list every field)."""
    h = hashlib.sha256()
    h.update(CKPT_VERSION.encode())
    for o in objs:
        h.update(repr(o).encode())
    return h.hexdigest()[:16]


class FingerprintMismatch(RuntimeError):
    pass


class CheckpointStore:
    """Pickle-per-key store.

    With a `fingerprint` (hash of code version + run config), the store
    refuses to resume from state written under a different fingerprint:
    a silent resume from stale state could report results computed by
    other code or other parameters.  A directory without a fingerprint
    is stamped on first open; pass on_mismatch="clear" to wipe stale
    state instead of raising.  Over several ranks every rank checks the
    fingerprint, rank 0 alone stamps, clears and saves, and the others
    wait for its stamp at a barrier.
    """

    def __init__(self, root: str, fingerprint: str | None = None,
                 on_mismatch: str = "raise"):
        self.root = root
        self.writer = is_writer()
        if self.writer:
            os.makedirs(root, exist_ok=True)
        if fingerprint is not None:
            fp_path = os.path.join(root, "_fingerprint.txt")
            existing = None
            if os.path.exists(fp_path):
                with open(fp_path) as fh:
                    existing = fh.read().strip()
            if existing is not None and existing != fingerprint \
                    and on_mismatch != "clear":
                raise FingerprintMismatch(
                    f"checkpoint dir {root} was written under "
                    f"fingerprint {existing}, current is {fingerprint}; "
                    "delete the directory (or pass on_mismatch='clear') "
                    "to recompute")
            if existing != fingerprint and self.writer:
                if existing is not None:
                    for name in os.listdir(root):
                        if name.endswith(".pkl") or name.endswith(".tmp"):
                            os.unlink(os.path.join(root, name))
                with open(fp_path + ".tmp", "w") as fh:
                    fh.write(fingerprint)
                os.replace(fp_path + ".tmp", fp_path)
        barrier()

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key + ".pkl")

    def has(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def load(self, key: str):
        with open(self._path(key), "rb") as fh:
            return pickle.load(fh)

    def save(self, key: str, obj) -> None:
        """Write `obj` to a .tmp file, then rename it over the key's file:
        a run killed mid-write leaves the previous value.  Only rank 0
        writes."""
        if not self.writer:
            return
        tmp = self._path(key) + ".tmp"
        with open(tmp, "wb") as fh:
            pickle.dump(obj, fh, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, self._path(key))

    def cached(self, key: str, fn):
        """Load `key` if present, else compute fn(), save, return."""
        if self.has(key):
            return self.load(key)
        obj = fn()
        self.save(key, obj)
        return obj


class Deadline:
    """Soft wall-clock budget: stages poll `expired` (or `near`) and stop
    cleanly, leaving the checkpoint store resumable.  Over several ranks
    each answer is rank 0's (`rank0_value`)."""

    def __init__(self, seconds: float | None):
        self.t_end = (time.time() + seconds) if seconds is not None \
            else None

    @property
    def expired(self) -> bool:
        return self.t_end is not None and \
            bool(rank0_value(float(time.time() >= self.t_end)))

    def near(self, margin: float) -> bool:
        """True within `margin` seconds of the deadline: stop launching
        new device work so the work in flight can be drained and saved
        before a hard kill."""
        return self.t_end is not None and \
            bool(rank0_value(float(time.time() >= self.t_end - margin)))

    def remaining(self) -> float:
        if self.t_end is None:
            return float("inf")
        return rank0_value(max(self.t_end - time.time(), 0.0))


class Incomplete(Exception):
    """Raised when the deadline expires mid-run; the checkpoint store
    holds everything computed so far."""

    def __init__(self, stage: str):
        super().__init__(f"deadline expired during {stage}; resumable")
        self.stage = stage


def check_deadline(deadline, stage: str) -> None:
    """Raise Incomplete(stage) if `deadline` (or None) has expired."""
    if deadline is not None and deadline.expired:
        raise Incomplete(stage)
