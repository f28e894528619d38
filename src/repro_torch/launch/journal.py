"""Write-ahead journal and atomic snapshots for the streaming twin server
(port of ``repro/launch/journal.py``; byte-compatible with it both ways).

:class:`~repro_torch.launch.fleet_serving.StreamingFleetServer` keeps a
whole population's carried ODE state in memory; this module is what
survives the process dying mid-pump.  A serving directory holds:

  ``journal.wal``   an append-only log of every externally visible event
                    (``config`` / ``register`` / ``submit`` / ``shed`` /
                    ``expire`` / ``quarantine`` / ``commit`` /
                    ``complete``), each record CRC-framed and fsync'd
                    before the caller is acknowledged;
  ``snapshots/``    full-state checkpoints (the store's hot slab copied
                    to the host, the queue, partial trajectories and
                    counters) written by
                    :func:`repro_torch.train.checkpoint.save`'s
                    temporary-directory-and-rename protocol, the journal
                    position standing in for the step.

A frame is ``<u32 payload_len LE><u32 crc32 LE><payload>``, the payload a
compact-JSON record.  A death mid-``write`` leaves a **torn tail**: a
last frame whose header, CRC or JSON does not check out.  The reader
stops at the first bad frame; :class:`Journal` truncates the tail before
it appends again.  That drops only work nobody was told about, since an
append is acknowledged after its fsync.

Recovery is the newest loadable snapshot plus a replay of the journal
after it (``StreamingFleetServer.recover``).  The journal holds
decisions and inputs (which requests, which tier, which window, initial
conditions), not trajectories: the serving loop's determinism contract
makes re-running a recorded window bitwise the first run.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.launch import chaos
from repro_torch.train import checkpoint as ckpt_lib

_FRAME = struct.Struct("<II")           # payload length, crc32(payload)

JOURNAL_NAME = "journal.wal"
SNAPSHOT_DIR = "snapshots"

#: Journal record-stream schema.  The config header pins it; ``recover``
#: refuses a journal of another schema instead of mis-replaying it.
JOURNAL_SCHEMA = 1


def read_journal(path: str) -> Tuple[List[dict], int, int]:
    """Scan a journal: ``(records, valid_bytes, torn_bytes)``.

    Decodes frames up to the first damaged one (short header, short
    payload, CRC mismatch or invalid JSON); everything from there on is
    the torn tail of an interrupted append.  A missing file is an empty
    journal.
    """
    if not os.path.exists(path):
        return [], 0, 0
    with open(path, "rb") as f:
        data = f.read()
    records: List[dict] = []
    off = 0
    while off + _FRAME.size <= len(data):
        length, crc = _FRAME.unpack_from(data, off)
        start = off + _FRAME.size
        payload = data[start:start + length]
        if len(payload) < length or zlib.crc32(payload) != crc:
            break
        try:
            rec = json.loads(payload.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError):
            break
        records.append(rec)
        off = start + length
    return records, off, len(data) - off


class Journal:
    """Append-only CRC-framed record log with fsync durability.

    Opening an existing journal truncates a torn tail and appends after
    the last valid record; ``lsn`` counts the valid records (the index the
    next append gets).  ``fsync=False`` trades durability for latency;
    ``append(..., sync=False)`` plus one :meth:`sync` is the group commit
    the pump uses for its bursts of records.
    """

    def __init__(self, path: str, *, fsync: bool = True):
        self.path = path
        self.fsync = bool(fsync)
        self.records, valid, torn = read_journal(path)
        self.torn_bytes_dropped = torn
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "ab")
        if torn:
            self._f.truncate(valid)
        self.lsn = len(self.records)

    def append(self, rec: dict, *, sync: Optional[bool] = None) -> int:
        """Append one record, fsync'd unless ``sync`` (or the journal's
        ``fsync``) says not; returns its lsn."""
        payload = json.dumps(rec, separators=(",", ":")).encode("utf-8")
        frame = _FRAME.pack(len(payload), zlib.crc32(payload)) + payload

        def torn_write():
            # what a death mid-write leaves: half a frame, on disk
            self._f.write(frame[: _FRAME.size + max(1, len(payload) // 2)])
            self._f.flush()
            os.fsync(self._f.fileno())

        chaos.kill_point("journal:torn_append", torn_write)
        self._f.write(frame)
        self._f.flush()
        if self.fsync if sync is None else sync:
            os.fsync(self._f.fileno())
        self.records.append(rec)
        self.lsn += 1
        return self.lsn - 1

    def sync(self) -> None:
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self.sync()
            self._f.close()

    @property
    def nbytes(self) -> int:
        return self._f.tell()


# ---------------------------------------------------------------------------
# Snapshots: full-state checkpoints on the journal's lsn axis
# ---------------------------------------------------------------------------

def write_snapshot(serve_dir: str, lsn: int, arrays: Dict[str, np.ndarray],
                   extra: dict, *, keep: int = 3) -> str:
    """Atomically publish a snapshot covering journal records [0, lsn):
    :func:`repro_torch.train.checkpoint.save` with the lsn as the step, so
    ordering, retention and the damage taxonomy are the checkpointer's.
    ``extra`` (the server's host state) rides in the manifest."""
    snap_dir = os.path.join(serve_dir, SNAPSHOT_DIR)
    os.makedirs(snap_dir, exist_ok=True)
    return ckpt_lib.save(snap_dir, lsn, dict(arrays), keep=keep,
                         extra=extra)


def load_latest_snapshot(serve_dir: str
                         ) -> Optional[Tuple[int, Dict[str, np.ndarray],
                                             dict]]:
    """Newest *loadable* snapshot as ``(lsn, arrays, extra)``.

    Snapshots are tried newest first; a damaged one (interrupted write,
    corrupt manifest, truncated arrays) is skipped for the next older
    one, since an older snapshot plus a longer replay is a correct
    recovery too.  Returns None when there is no snapshot; raises when
    snapshots exist and none loads.
    """
    snap_dir = os.path.join(serve_dir, SNAPSHOT_DIR)
    steps = ckpt_lib.all_steps(snap_dir)
    if not steps:
        return None
    errors = []
    for lsn in reversed(steps):
        path = os.path.join(snap_dir, f"step_{lsn:010d}")
        try:
            arrays, manifest = ckpt_lib.load_arrays(path)
        except (FileNotFoundError, ValueError) as e:
            errors.append(f"{path}: {e}")
            continue
        return lsn, arrays, manifest.get("extra", {})
    raise ValueError(
        "every snapshot under {!r} is damaged:\n  {}".format(
            snap_dir, "\n  ".join(errors)))


def journal_path(serve_dir: str) -> str:
    return os.path.join(serve_dir, JOURNAL_NAME)


def json_floats(x) -> list:
    """float32 to JSON without loss: a Python float (float64) holds any
    float32 exactly, so journalled initial conditions replay bitwise."""
    return [float(v) for v in np.asarray(x, np.float32).reshape(-1)]


def from_json_floats(vals, shape) -> np.ndarray:
    return np.asarray(vals, np.float32).reshape(shape)
