"""Checkpoints in the JAX package's on-disk format (port of ``repro/train/checkpoint.py``).

One directory per step, ``step_XXXXXXXXXX/``, holding ``manifest.json``
(``{"schema": 1, "step": n, "leaves": {path: {"file", "dtype",
"shape"}}}``, leaf paths such as ``params/0/w``) and one
``arr_XXXXX.npy`` per leaf.  Leaves are numbered in the JAX package's
flattening order (dict keys sorted, lists by index), so a twin saved by
either package loads in the other.  Writes are atomic: a temporary
directory, renamed into place once complete; the kill point
``snapshot:pre_rename`` (:mod:`repro_torch.launch.chaos`) sits between
the two.  ``save(..., blocking=False)`` copies the tensors to the host at
once and leaves the file writes to one writer thread
(:func:`wait_for_async` waits for it).  ``extra`` rides in the manifest:
the streaming server's snapshots keep their queue and counters there.
"""
from __future__ import annotations

import itertools
import json
import os
import queue
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.launch import chaos
from repro_torch.launch.sharding import device_put

Tree = Any

#: On-disk manifest schema version (the JAX package's).
SCHEMA_VERSION = 1

_TMP_COUNTER = itertools.count()


def _flatten(tree: Tree, prefix: str = "") -> list:
    """``[(leaf path, leaf)]`` in the JAX package's order: dict keys
    sorted, lists and tuples by index."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def _unflatten(template: Tree, leaves: dict, prefix: str = "") -> Tree:
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        seq = [_unflatten(v, leaves, f"{prefix}/{i}" if prefix else str(i))
               for i, v in enumerate(template)]
        return type(template)(seq)
    return leaves[prefix]


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(ckpt_dir: str, step: int, tree: Tree, *, keep: int = 3,
         blocking: bool = True, extra: Optional[dict] = None) -> str:
    """Atomically persist a tree of tensors; returns the step directory
    (a placement is saved from ``Placed.gather()``).
    Retention keeps the newest ``keep`` steps.  ``extra`` (JSON-ready) is
    stored in the manifest and published with the arrays.  With
    ``blocking=False`` the device-to-host copies happen here and the
    writes on the writer thread."""
    host = [(n, _to_numpy(x)) for n, x in _flatten(tree)]
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + f".tmp{os.getpid()}_{next(_TMP_COUNTER)}"

    def write():
        os.makedirs(tmp, exist_ok=True)
        manifest = {}
        for i, (name, arr) in enumerate(host):
            fname = f"arr_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest[name] = {"file": fname, "dtype": str(arr.dtype),
                              "shape": list(arr.shape)}
        body = {"schema": SCHEMA_VERSION, "step": step, "leaves": manifest}
        if extra is not None:
            body["extra"] = extra
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(body, f)
        chaos.kill_point("snapshot:pre_rename")
        try:
            os.replace(tmp, final)      # atomic publish
        except OSError:
            # a concurrent save already published this step — drop ours
            shutil.rmtree(tmp, ignore_errors=True)
        _apply_retention(ckpt_dir, keep)

    if blocking:
        write()
    else:
        _writer().submit(write)
    return final


class _Writer:
    """One daemon thread that runs submitted writes in order.  A write
    that dies at a kill point (``chaos.SimulatedCrash``) ends that job
    with nothing renamed, as a killed process would leave it, and the
    thread goes on: a dead writer would make :func:`wait_for_async` wait
    for ever."""

    def __init__(self):
        self.q: queue.Queue = queue.Queue()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while True:
            job = self.q.get()
            try:
                job()
            except chaos.SimulatedCrash as e:
                print(f"[checkpoint] async write died: {e}")
            except Exception as e:
                print(f"[checkpoint] async write failed: {e}")
            finally:
                self.q.task_done()

    def submit(self, job):
        self.q.put(job)

    def wait(self):
        self.q.join()


_WRITER: Optional[_Writer] = None
_WRITER_LOCK = threading.Lock()


def _writer() -> _Writer:
    global _WRITER
    with _WRITER_LOCK:
        if _WRITER is None:
            _WRITER = _Writer()
        return _WRITER


def wait_for_async() -> None:
    """Block until every ``save(..., blocking=False)`` so far is on disk
    (or has died at a kill point)."""
    if _WRITER is not None:
        _WRITER.wait()


def _apply_retention(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and ".tmp" not in d)
    for old in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, old), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list:
    """Every published checkpoint step under ``ckpt_dir``, ascending;
    in-flight ``.tmp`` writes are excluded."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and ".tmp" not in d)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def read_manifest(path: str) -> dict:
    """Load + validate a checkpoint manifest, raising errors that say
    exactly what is wrong with the on-disk state (missing vs truncated
    vs corrupt vs incompatible)."""
    mpath = os.path.join(path, "manifest.json")
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"checkpoint directory {path!r} does not exist")
    if not os.path.exists(mpath):
        raise FileNotFoundError(
            f"checkpoint {path!r} has no manifest.json — the write was "
            f"interrupted before the atomic publish (or the directory "
            f"was truncated); delete it and restore an older step")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except json.JSONDecodeError as e:
        raise ValueError(
            f"checkpoint manifest {mpath!r} is corrupt (invalid JSON: "
            f"{e}) — the checkpoint cannot be trusted") from e
    if not isinstance(manifest, dict) or "leaves" not in manifest:
        raise ValueError(
            f"checkpoint manifest {mpath!r} is malformed: expected a "
            f"JSON object with a 'leaves' table, got "
            f"{type(manifest).__name__}")
    schema = manifest.get("schema", 1)   # pre-versioned manifests == v1
    if schema != SCHEMA_VERSION:
        raise ValueError(
            f"checkpoint {path!r} uses manifest schema {schema}, this "
            f"reader understands schema {SCHEMA_VERSION} — upgrade the "
            f"checkpoint (or the reader) before restoring")
    return manifest


def _load_leaf(path: str, name: str, meta: dict) -> np.ndarray:
    fpath = os.path.join(path, meta["file"])
    if not os.path.exists(fpath):
        raise FileNotFoundError(
            f"checkpoint {path!r} is truncated: manifest lists "
            f"{meta['file']!r} for leaf {name!r} but the file is missing")
    try:
        return np.load(fpath)
    except (ValueError, OSError) as e:
        raise ValueError(
            f"checkpoint array {fpath!r} (leaf {name!r}) is corrupt: "
            f"{e}") from e


def load_arrays(path: str):
    """Blind restore of one checkpoint directory: every leaf the manifest
    lists, as numpy arrays keyed by leaf path — no template required.
    Returns ``(arrays, manifest)``; raises the damage taxonomy of
    :func:`read_manifest` plus truncated, corrupt or reshaped arrays."""
    manifest = read_manifest(path)
    arrays = {}
    for name, meta in manifest["leaves"].items():
        arr = _load_leaf(path, name, meta)
        if list(arr.shape) != list(meta["shape"]):
            raise ValueError(
                f"{name}: array shape {list(arr.shape)} != manifest "
                f"shape {meta['shape']} — the checkpoint is internally "
                f"inconsistent")
        arrays[name] = arr
    return arrays, manifest


def restore(ckpt_dir: str, step: int, target: Tree, *,
            device=None, shardings: Optional[Tree] = None) -> Tree:
    """Restore into the structure of ``target`` (tensors give the shape
    and dtype of each leaf).  Leaves go to ``device``, or to the device of
    the matching template tensor when ``device`` is None.

    ``shardings``: a tree of :class:`repro_torch.launch.sharding
    .NamedSharding` with ``target``'s structure, all on one mesh; the
    tree is then placed by them
    (:func:`repro_torch.launch.sharding.device_put`, which returns a
    :class:`~repro_torch.launch.sharding.Placed`), whatever placement the
    checkpoint was saved from: restarts are elastic across topologies.
    Giving ``device`` too raises.

    Raises for on-disk damage and for template mismatches (a leaf the
    checkpoint never stored, or stored with another shape)."""
    if shardings is not None and device is not None:
        raise ValueError(
            "restore: give device= or shardings=, not both (a sharding "
            "names its devices)")
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    manifest = read_manifest(path)["leaves"]
    out = {}
    for name, tgt in _flatten(target):
        if name not in manifest:
            raise KeyError(
                f"checkpoint {path!r} has no leaf {name!r} (stores "
                f"{sorted(manifest)[:8]}{'...' if len(manifest) > 8 else ''})"
                f" — the params template does not match the saved twin")
        arr = _load_leaf(path, name, manifest[name])
        if tuple(arr.shape) != tuple(tgt.shape):
            raise ValueError(
                f"{name}: checkpoint shape {tuple(arr.shape)} != template "
                f"shape {tuple(tgt.shape)} — the checkpointed twin has a "
                f"different architecture than the params template")
        if shardings is not None:
            out[name] = torch.from_numpy(arr).to(dtype=tgt.dtype)
        else:
            out[name] = torch.from_numpy(arr).to(
                device=tgt.device if device is None else device,
                dtype=tgt.dtype)
    tree = _unflatten(target, out)
    if shardings is None:
        return tree
    return device_put(tree, shardings)


def save_twin(ckpt_dir: str, params: Tree, *, step: int = 0,
              blocking: bool = True, keep: int = 3) -> str:
    """Persist a trained twin's weights under the canonical
    ``{"params": ...}`` layout that :func:`load_twin` (and the JAX
    package's ``load_twin``) expects."""
    return save(ckpt_dir, step, {"params": params}, blocking=blocking,
                keep=keep)


def load_twin(ckpt_dir: str, params_template: Tree, *,
              step: Optional[int] = None, device=None,
              shardings: Optional[Tree] = None) -> Tree:
    """Restore twin weights saved by :func:`save_twin` in either package.

    ``params_template`` supplies the structure, shapes and dtypes (an
    untrained ``twin.init(generator)`` works — values are discarded);
    ``step=None`` loads the newest checkpoint.  ``shardings`` places the
    weights on a serving mesh instead of one ``device`` (normally the
    replicated placement of
    :func:`repro_torch.launch.sharding.fleet_param_shardings`); the
    :class:`~repro_torch.launch.sharding.Placed` it returns is what
    ``FleetServer`` and ``StreamingFleetServer`` take as ``params``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(
                f"no twin checkpoint found under {ckpt_dir!r}")
    if shardings is not None and device is not None:
        raise ValueError(
            "load_twin: give device= or shardings=, not both (a sharding "
            "names its devices)")
    params = restore(ckpt_dir, step, {"params": params_template},
                     device="cpu" if shardings is not None else device
                     )["params"]
    if shardings is None:
        return params
    return device_put(params, shardings)
