"""`-flag value...` multimap argument parser (a copy of
`pepr_tpu/utils/cli.py`, which imports nothing of JAX).

Re-creates the reference's CommandLineProperties (CommandLineProperties.
java:44-95: args split on flags starting with '-', multiple values per
flag, later additions take precedence; :162-178 round-trip to/from file).
This is the config spine of the whole pipeline: presets (-track), -conf
files, and explicit args are merged with explicit-args-win semantics
(PhyloPipeline.java:176-205).
"""

from __future__ import annotations

import os


def _is_flag(tok: str) -> bool:
    if not tok.startswith("-") or len(tok) < 2:
        return False
    # Negative numbers are values, not flags.
    try:
        float(tok)
        return False
    except ValueError:
        return True


class RunProperties:
    """Multimap of flag -> list of values; most recently added values
    are returned first (CommandLineProperties.java:80-95)."""

    def __init__(self, args: list[str] | None = None):
        self._map: dict[str, list[str]] = {}
        if args:
            self.add_args(args)

    def add_args(self, args: list[str]) -> None:
        i = 0
        n = len(args)
        while i < n:
            tok = args[i]
            if _is_flag(tok):
                flag = tok.lstrip("-")
                vals = []
                i += 1
                while i < n and not _is_flag(args[i]):
                    vals.append(args[i])
                    i += 1
                # Newest-first within the flag.
                self._map.setdefault(flag, [])
                self._map[flag] = vals + self._map[flag]
            else:
                i += 1

    def add(self, flag: str, *values: str) -> None:
        self.add_args(["-" + flag, *[str(v) for v in values]])

    def values(self, flag: str, *default: str) -> list[str]:
        got = self._map.get(flag.lstrip("-"))
        if got is None or len(got) == 0:
            return list(default)
        return list(got)

    def get(self, flag: str, default: str | None = None) -> str | None:
        got = self.values(flag)
        if got:
            return got[0]
        return default

    def get_bool(self, flag: str, default: bool = False) -> bool:
        v = self.get(flag)
        if v is None:
            # Bare flag present with no value means true.
            return flag.lstrip("-") in self._map or default
        return v.lower() in ("true", "1", "yes", "t")

    def get_int(self, flag: str, default: int | None = None) -> int | None:
        v = self.get(flag)
        return int(v) if v is not None else default

    def get_float(self, flag: str, default: float | None = None) -> float | None:
        v = self.get(flag)
        return float(v) if v is not None else default

    def __contains__(self, flag: str) -> bool:
        return flag.lstrip("-") in self._map

    def flags(self) -> list[str]:
        return list(self._map)

    def to_args(self) -> list[str]:
        out: list[str] = []
        for flag, vals in self._map.items():
            out.append("-" + flag)
            out.extend(vals)
        return out

    def save(self, path: str) -> None:
        """Write a re-runnable args file (one token per line), the
        reference's `<run>.clp` affordance (PhyloPipeline.java:1297-1314)."""
        with open(path, "w") as fh:
            for tok in self.to_args():
                fh.write(tok + "\n")

    @classmethod
    def load(cls, path: str) -> "RunProperties":
        with open(path) as fh:
            toks = [t for line in fh for t in line.split()]
        return cls(toks)

    def merged_under(self, overrides: "RunProperties") -> "RunProperties":
        """New properties where `overrides` wins over self (preset /
        -conf layering semantics, PhyloPipeline.java:196-205)."""
        out = RunProperties()
        out.add_args(self.to_args())
        out.add_args(overrides.to_args())
        return out


def expand_paths(patterns: list[str]) -> list[str]:
    """Expand globs/dirs into file lists (genome_file flag handling)."""
    import glob
    out: list[str] = []
    for p in patterns:
        if os.path.isdir(p):
            out.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if f.endswith((".faa", ".fasta", ".fa"))))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(glob.glob(p)))
        else:
            out.append(p)
    return out


def setup_logfile(path: str, max_bytes: int = 10 * 2 ** 20,
                  backups: int = 100) -> None:
    """Rolling-file log handler — the reference's log4j
    RollingFileAppender role (lib/log4j.properties:1-10: 10MB files,
    100 backups, `-Dlogfile.name` via scripts/pepr.sh:15).  Attaches
    to the root logger at INFO so every pepr_tpu_torch stage line lands
    in the file as well as the console."""
    import logging
    import logging.handlers

    handler = logging.handlers.RotatingFileHandler(
        path, maxBytes=max_bytes, backupCount=backups)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)-5s %(name)s - %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S"))
    handler.setLevel(logging.INFO)
    root = logging.getLogger()
    if root.level > logging.INFO or root.level == logging.NOTSET:
        root.setLevel(logging.INFO)
    root.addHandler(handler)
