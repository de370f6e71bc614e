"""Resumable on-disk grid journal for the sweep driver.

A calibrated 10k-point trace × policy × mix × calibration study cannot
afford to lose hours of finished grid points to one preempted host: the
sweep driver (:mod:`repro_torch.rms.sweep`) appends every completed row to a
*journal* — an append-only JSONL file — the moment it finishes, so a
killed sweep resumes by replaying only the missing points
(``--resume``), and shards running on different hosts (``--shard i/N``)
merge by simply reading each other's journals.

Design constraints, in order:

1. **Kill-safety.**  Each entry is one ``\\n``-terminated JSON line
   written with a single ``os.write`` to an ``O_APPEND`` descriptor and
   fsynced — a crash can truncate at most the last line, never corrupt
   earlier entries.  :meth:`GridJournal.load` tolerates a trailing
   partial line (and any undecodable line) by skipping it: those points
   simply re-run on resume.
2. **Self-describing entries.**  An entry carries the canonical row key
   (:func:`repro_torch.rms.sweep.row_key` of the finished row), the grid-point
   *fingerprint* it was produced from, and the row itself.  Resume
   matches on the key but *verifies* the fingerprint — a journal written
   under a different grid (e.g. another ``--max-jobs``) fails loudly
   instead of silently serving wrong rows.
3. **Merge-determinism.**  Journals carry no ordering promises; the
   sweep driver re-sorts merged rows by ``row_key``, so the final
   artifact is byte-identical to a fresh serial run no matter how many
   hosts/kills/resumes produced it (pinned by ``tests/test_journal.py``).

File format: first line is a header object
(``{"journal": "repro.rms.sweep", "version": 1}``); every further line is
``{"key": "...", "point": {...}, "row": {...}}``.  Duplicate keys are
legal (two resumed runs may race the same point); the *last* complete
entry wins — by determinism both carry the same row anyway.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional

JOURNAL_ID = "repro.rms.sweep"
JOURNAL_VERSION = 1


class JournalMismatch(ValueError):
    """A journal entry exists for a key but was produced by a different
    grid point (or an incompatible journal format)."""


class GridJournal:
    """Append-only completed-point journal (one instance per writer)."""

    def __init__(self, path: str):
        self.path = path
        self._fd: Optional[int] = None

    # -- writing -------------------------------------------------------------

    def _ensure_open(self) -> int:
        if self._fd is None:
            needs_header = True
            needs_newline = False
            if os.path.exists(self.path) and os.path.getsize(self.path) > 0:
                needs_header = False
                with open(self.path, "rb") as fh:
                    fh.seek(-1, os.SEEK_END)
                    needs_newline = fh.read(1) != b"\n"
            self._fd = os.open(self.path,
                               os.O_WRONLY | os.O_APPEND | os.O_CREAT,
                               0o644)
            if needs_header:
                header = json.dumps({"journal": JOURNAL_ID,
                                     "version": JOURNAL_VERSION},
                                    sort_keys=True)
                os.write(self._fd, (header + "\n").encode())
                os.fsync(self._fd)
            elif needs_newline:
                # A kill truncated the last entry mid-write: terminate the
                # partial line so it stays isolated (and skipped on load)
                # instead of swallowing the next appended entry.
                os.write(self._fd, b"\n")
                os.fsync(self._fd)
        return self._fd

    def append(self, key: str, row: Dict[str, object],
               point: Optional[Dict[str, object]] = None) -> None:
        """Durably append one completed row.

        The whole entry goes down in a single ``os.write`` on an
        ``O_APPEND`` descriptor (atomic with respect to other appenders)
        followed by ``fsync`` — after this returns, the row survives a
        kill."""
        entry = {"key": key, "row": row}
        if point is not None:
            entry["point"] = point
        line = json.dumps(entry, sort_keys=True) + "\n"
        fd = self._ensure_open()
        os.write(fd, line.encode())
        os.fsync(fd)

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self) -> "GridJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- reading -------------------------------------------------------------

    @staticmethod
    def load(path: str) -> Dict[str, Dict[str, object]]:
        """Read a journal: ``{key: entry}`` with undecodable (partial)
        lines skipped — their points re-run on resume.  A missing file is
        an empty journal."""
        entries: Dict[str, Dict[str, object]] = {}
        if not os.path.exists(path):
            return entries
        with open(path, "rb") as fh:
            for raw in fh:
                try:
                    obj = json.loads(raw.decode("utf-8"))
                except (json.JSONDecodeError, UnicodeDecodeError):
                    continue            # partial trailing line: re-run it
                if not isinstance(obj, dict):
                    continue
                if "journal" in obj:    # header line
                    if obj.get("journal") != JOURNAL_ID:
                        raise JournalMismatch(
                            f"{path}: not a sweep journal "
                            f"(journal={obj.get('journal')!r})")
                    if obj.get("version") != JOURNAL_VERSION:
                        raise JournalMismatch(
                            f"{path}: journal version "
                            f"{obj.get('version')} != {JOURNAL_VERSION}")
                    continue
                key, row = obj.get("key"), obj.get("row")
                if isinstance(key, str) and isinstance(row, dict):
                    entries[key] = obj  # last complete entry wins
        return entries

    @staticmethod
    def load_many(paths: Iterable[str]) -> Dict[str, Dict[str, object]]:
        """Merge several journals (shards, prior attempts): later paths
        win on duplicate keys — irrelevant in practice, since determinism
        makes duplicate rows identical."""
        merged: Dict[str, Dict[str, object]] = {}
        for path in paths:
            merged.update(GridJournal.load(path))
        return merged


def parse_shard(spec: str) -> List[int]:
    """``"i/N"`` → ``[i, N]`` with ``0 <= i < N`` — the deterministic
    grid partition selector (shard ``i`` takes grid points ``i, i+N,
    i+2N, ...`` in build order)."""
    try:
        i_s, n_s = spec.split("/", 1)
        i, n = int(i_s), int(n_s)
    except ValueError:
        raise ValueError(f"shard spec must be i/N, got {spec!r}") from None
    if n <= 0 or not 0 <= i < n:
        raise ValueError(f"shard index out of range: {spec!r} "
                         f"(need 0 <= i < N)")
    return [i, n]
