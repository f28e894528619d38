"""Per-twin ODE state carried between streaming requests, with host paging
(port of ``repro/launch/state_store.py``).

A streaming twin population is resident state, not request payload: each
physical asset owns a carried ``(y, global step)`` pair that every new
sensor window advances.  The population may exceed what should sit on
the card beside the serving kernels, so the store has two levels:

  * **hot slab**: one ``(hot_capacity, D)`` float32 tensor on the
    server's device.  A batch's twins are promoted into it; the batch
    assembler gathers their rows with one indexed read and scatters the
    results back with one indexed write.
  * **cold pages**: numpy rows on the host, one per twin.  Eviction is
    LRU over the hot slots: promoting into a full slab pages the least
    recently used unpinned twins out first, then reuses their slots.
    State moves and is never dropped.

A fetch that evicts copies all its evicted rows to the host in ONE
device-to-host read, before any of their slots is written (the JAX
package copies each evicted row on its own); :class:`StoreStats` counts
the same either way.

Metadata (global step, per-twin drive parameters) lives on the host:
steps parameterise the canonical float64 time grid
(:func:`repro_torch.kernels.ops.window_times`).  The store is
synchronous and single-writer; the streaming server owns it.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch import chaos

TwinId = Any


@dataclasses.dataclass
class StoreStats:
    """Paging counters (one per store)."""
    registered: int = 0
    hot_hits: int = 0        # fetches served from the hot slab
    page_ins: int = 0        # cold -> hot promotions
    evictions: int = 0       # hot -> cold LRU pagings
    commits: int = 0         # state writes after served batches

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class TwinStateStore:
    """Two-level (device-hot / host-cold) store of per-twin ODE state.

    ``hot_capacity`` bounds the device-resident population; the rest
    pages to host numpy rows with LRU eviction.  ``fetch`` promotes and
    gathers, ``commit`` scatters back; both take id lists, so the serving
    loop touches the device a fixed number of times per batch.
    ``device`` is where the hot slab lives (default ``cuda``; tests pass
    ``"cpu"``).
    """

    def __init__(self, state_dim: int, hot_capacity: int, *, device=None):
        if hot_capacity < 1:
            raise ValueError(
                f"TwinStateStore: hot_capacity must be >= 1, got "
                f"{hot_capacity}")
        self.state_dim = int(state_dim)
        self.hot_capacity = int(hot_capacity)
        self._hot = torch.zeros((self.hot_capacity, self.state_dim),
                                dtype=torch.float32,
                                device=resolve_device(device))
        self._free: list[int] = list(range(self.hot_capacity))[::-1]
        self._slot_of: "OrderedDict[TwinId, int]" = OrderedDict()  # LRU
        self._cold: dict[TwinId, np.ndarray] = {}
        self._step: dict[TwinId, int] = {}
        self._theta: dict[TwinId, Optional[np.ndarray]] = {}
        self.stats = StoreStats()

    @property
    def device(self) -> torch.device:
        return self._hot.device

    # -- population --------------------------------------------------------
    def __contains__(self, twin_id: TwinId) -> bool:
        return twin_id in self._step

    def __len__(self) -> int:
        return len(self._step)

    @property
    def hot_ids(self) -> list:
        """Device-resident twins, least recently used first."""
        return list(self._slot_of)

    def register(self, twin_id: TwinId, y0, *, theta=None,
                 step: int = 0) -> None:
        """Admit a new twin with its initial state (host-side: nothing
        touches the device until the twin is first batched)."""
        if twin_id in self:
            raise ValueError(f"twin {twin_id!r} already registered")
        y0 = np.asarray(y0, np.float32)
        if y0.shape != (self.state_dim,):
            raise ValueError(
                f"twin {twin_id!r}: y0 shape {y0.shape} != "
                f"({self.state_dim},)")
        if not np.isfinite(y0).all():
            raise ValueError(
                f"twin {twin_id!r}: y0 contains non-finite values")
        self._cold[twin_id] = y0
        self._step[twin_id] = int(step)
        self._theta[twin_id] = (None if theta is None
                                else np.asarray(theta, np.float32))
        self.stats.registered += 1

    # -- paging ------------------------------------------------------------
    def _evict_lru(self, pinned: set, evicted: list) -> int:
        """Unmap the least recently used unpinned hot twin, note it in
        ``evicted`` as ``(twin_id, slot)`` and return its slot.  The
        caller copies the noted rows out before it writes the slots."""
        chaos.kill_point("store:evict")
        for twin_id in self._slot_of:          # iteration order = LRU
            if twin_id not in pinned:
                slot = self._slot_of.pop(twin_id)
                evicted.append((twin_id, slot))
                self.stats.evictions += 1
                return slot
        raise RuntimeError(
            f"TwinStateStore: cannot evict — all {self.hot_capacity} hot "
            f"slots are pinned by the current batch (batch larger than "
            f"hot_capacity?)")

    def _index(self, slots) -> torch.Tensor:
        return torch.as_tensor(slots, dtype=torch.long).to(self.device)

    def fetch(self, twin_ids: Sequence[TwinId]):
        """Promote ``twin_ids`` to the hot slab and gather their state.

        Returns ``(ys, steps, thetas)``: ``ys`` an (n, D) tensor on the
        store's device, ``steps`` a host (n,) int64 array of global steps,
        ``thetas`` an (n, ...) float32 tensor of drive parameters on the
        device (None when no twin carries one).  The requested twins are
        pinned during the promotion, so a fetch of more than
        ``hot_capacity`` twins raises instead of thrashing.
        """
        ids = list(twin_ids)
        unknown = [i for i in ids if i not in self]
        if unknown:
            raise KeyError(f"unregistered twin(s): {unknown!r}")
        if len(set(ids)) != len(ids):
            raise ValueError(
                "fetch: duplicate twin ids in one batch (a twin's next "
                "window depends on its previous one — serialise them)")
        if len(ids) > self.hot_capacity:
            raise ValueError(
                f"fetch: batch of {len(ids)} exceeds hot_capacity "
                f"{self.hot_capacity}")
        pinned = set(ids)
        page_in, evicted = [], []              # (twin, slot) pairs
        for twin_id in ids:
            if twin_id in self._slot_of:
                self.stats.hot_hits += 1
                self._slot_of.move_to_end(twin_id)    # touch: now MRU
            else:
                slot = (self._free.pop() if self._free
                        else self._evict_lru(pinned, evicted))
                page_in.append((twin_id, slot))
                self._slot_of[twin_id] = slot
                self.stats.page_ins += 1
        if evicted:                            # out first, in one read
            rows = self._hot[self._index([s for _, s in evicted])].cpu()
            for (twin_id, _), row in zip(evicted, rows.numpy()):
                self._cold[twin_id] = row
        if page_in:
            rows = np.stack([self._cold.pop(i) for i, _ in page_in])
            self._hot[self._index([s for _, s in page_in])] = \
                torch.from_numpy(rows).to(self.device)
        ys = self._hot[self._index([self._slot_of[i] for i in ids])]
        steps = np.asarray([self._step[i] for i in ids], np.int64)
        th = [self._theta[i] for i in ids]
        if all(t is None for t in th):
            thetas = None
        elif any(t is None for t in th):
            raise ValueError(
                "fetch: mixed drive parameters — a fleet either drives "
                "every twin (register all with theta=) or none")
        else:
            thetas = torch.from_numpy(np.stack(th)).to(self.device)
        return ys, steps, thetas

    def commit(self, twin_ids: Sequence[TwinId], ys, steps) -> None:
        """Scatter served end states into the hot slab and advance the
        per-twin global steps.  ``ys`` is (n, D) (tensor or array);
        ``steps`` the new absolute step indices."""
        ids = list(twin_ids)
        missing = [i for i in ids if i not in self._slot_of]
        if missing:
            raise KeyError(
                f"commit: twin(s) {missing!r} are not hot — fetch pins "
                f"a batch's twins until its commit")
        self._hot[self._index([self._slot_of[i] for i in ids])] = \
            torch.as_tensor(ys).to(self.device, torch.float32)
        for i, s in zip(ids, np.asarray(steps, np.int64)):
            self._step[i] = int(s)
        self.stats.commits += 1

    # -- inspection and snapshots ------------------------------------------
    def export_state(self):
        """The whole population on the host, for a snapshot: ``(ids, ys,
        steps, thetas)`` in registration order, the hot rows read out of
        the slab in one device-to-host copy (LRU order untouched).
        ``ys`` is (N, D) float32, ``steps`` (N,) int64, ``thetas`` None
        for an undriven population, else (N, ...) float32."""
        ids = list(self._step)
        if not ids:
            return ids, np.zeros((0, self.state_dim), np.float32), \
                np.zeros((0,), np.int64), None
        hot = self._hot.cpu().numpy() if self._slot_of else None
        ys = np.stack([hot[self._slot_of[i]] if i in self._slot_of
                       else self._cold[i] for i in ids])
        steps = np.asarray([self._step[i] for i in ids], np.int64)
        th = [self._theta[i] for i in ids]
        thetas = None if all(t is None for t in th) else \
            np.stack(th).astype(np.float32)
        return ids, ys, steps, thetas

    def peek(self, twin_id: TwinId):
        """Read one twin's ``(y, step)`` without touching LRU order."""
        if twin_id not in self:
            raise KeyError(f"unregistered twin {twin_id!r}")
        if twin_id in self._slot_of:
            y = self._hot[self._slot_of[twin_id]].cpu().numpy().copy()
        else:
            y = self._cold[twin_id]
        return y, self._step[twin_id]

    def theta(self, twin_id: TwinId):
        return self._theta[twin_id]

    def check_invariants(self) -> None:
        """Structural audit: every registered twin is in exactly one tier,
        slots are bijective, no state row is non-finite (the hot slab is
        read back in one copy)."""
        hot, cold = set(self._slot_of), set(self._cold)
        if hot & cold:
            raise AssertionError(f"twins in both tiers: {hot & cold}")
        if hot | cold != set(self._step):
            raise AssertionError("registered twins != hot + cold")
        slots = list(self._slot_of.values())
        if len(set(slots)) != len(slots):
            raise AssertionError("hot slot collision")
        if set(slots) & set(self._free):
            raise AssertionError("occupied slot on the free list")
        if len(slots) + len(self._free) != self.hot_capacity:
            raise AssertionError("slot leak: occupied + free != capacity")
        hot_rows = self._hot.cpu().numpy()
        for tid, slot in self._slot_of.items():
            if not np.isfinite(hot_rows[slot]).all():
                raise AssertionError(f"twin {tid!r} state went non-finite")
        for tid, y in self._cold.items():
            if not np.isfinite(y).all():
                raise AssertionError(f"twin {tid!r} state went non-finite")
