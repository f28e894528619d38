"""The paper's energy scorecard, connected to real rollouts (port of ``repro/core/scorecard.py``).

:mod:`repro_torch.core.energy` carries the calibrated speed/energy model
and the paper's reported anchors (Fig. 3k,l / Fig. 4h,i).  This module
joins it to what a rollout executes on each of the port's substrates:

1. **Anchor rows** — the four headline ratios the paper reports
   (HP: 4.2x speed, 41.4x energy vs the GPU neural-ODE; Lorenz96:
   12.6x speed, 189.7x energy), recomputed from the calibrated model
   and checked against the paper values within :data:`ANCHOR_TOL`.

2. **Backend rows** — for each substrate, the twin's rollout runs once
   under a :class:`repro_torch.kernels.work.WorkCounter`, which counts
   what it executes: ``torch.utils.flop_counter.FlopCounterMode`` for the
   plain aten operations, and for the hand-written kernels (K1 / K1w,
   K4 / K4w, K7) the analytic work each entry point reports once per
   call (its plain version runs uncounted), so a rollout counts the
   same on the CPU and on the card.  The JAX package parses the
   compiled program's HLO instead; the row's counts sit under
   ``"counted"`` (JAX: ``"hlo"``).  Then:

   * digital substrates (``digital``, ``fused_cuda``) project time and
     energy from the counted MACs through
     :func:`repro_torch.core.energy.project_from_macs`;
   * analogue substrates (``analogue``, ``analogue_fused_cuda``) project
     from array physics (settling time x stages, peripheral + array
     power) via :func:`repro_torch.core.energy.project` — an analogue
     array settles, it does not execute MACs; the simulator's counts stay
     in the row for transparency (the differential pair doubles its
     products).

The two workloads are the paper's: the HP memristor twin (hidden 64,
500 steps) and the Lorenz96 twin (hidden 512, 1800 interpolation steps),
both three crossbar layers.  On the card the Lorenz96 rows run the wide
cluster kernels K1w and K4w.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.core import energy
from repro_torch.device import resolve_device
from repro_torch.kernels import work

#: Relative tolerance for the paper-anchor assertions (the calibrated
#: model hits most anchors to <6%, the worst to ~17%).
ANCHOR_TOL = 0.20


@dataclasses.dataclass(frozen=True)
class Workload:
    """One paper workload: a twin topology plus a trajectory length."""
    name: str
    state_dim: int
    drive_dim: int            # 0 = autonomous (Lorenz96), 1 = driven (HP)
    hidden: int
    n_layers: int = 3         # weight matrices (= crossbar arrays)
    n_steps: int = 500

    @property
    def in_dim(self) -> int:
        return self.state_dim + self.drive_dim

    @property
    def out_dim(self) -> int:
        return self.state_dim

    def mlp_sizes(self) -> tuple:
        return ((self.in_dim,) + (self.hidden,) * (self.n_layers - 1)
                + (self.out_dim,))

    def macs_per_eval(self) -> float:
        s = self.mlp_sizes()
        return float(sum(a * b for a, b in zip(s[:-1], s[1:])))

    def macs_per_trajectory(self) -> float:
        return 4.0 * self.n_steps * self.macs_per_eval()   # RK4: 4 f-evals


#: Fig. 3k,l configuration: HP memristor twin, MLP 2 -> 64 -> 64 -> 1.
HP = Workload("hp", state_dim=1, drive_dim=1, hidden=64, n_steps=500)
#: Fig. 4h,i configuration: Lorenz96 twin, MLP 6 -> 512 -> 512 -> 6.
LORENZ96 = Workload("lorenz96", state_dim=6, drive_dim=0, hidden=512,
                    n_steps=1800)
WORKLOADS = (HP, LORENZ96)

#: Substrate class of each of the port's backends — selects the
#: projection path (counted MACs through the digital model vs array
#: physics).  JAX's ``fused_pallas`` / ``analogue_fused`` are the port's
#: ``fused_cuda`` / ``analogue_fused_cuda``.
BACKEND_SUBSTRATE = {
    "digital": "digital",
    "fused_cuda": "digital",
    "analogue": "analogue",
    "analogue_fused_cuda": "analogue",
}


# ---------------------------------------------------------------------------
# Anchor rows — the four gated paper ratios
# ---------------------------------------------------------------------------

def _workload_ratios(w: Workload):
    kw = dict(in_dim=w.in_dim, out_dim=w.out_dim, n_layers=w.n_layers,
              n_steps=w.n_steps)
    t_a, e_a = energy.project("analogue_node", w.hidden, **kw)
    t_d, e_d = energy.project("node_gpu", w.hidden, **kw)
    return t_d / t_a, e_d / e_a


def anchor_rows(tol: float = ANCHOR_TOL) -> list:
    """The four headline paper anchors vs the calibrated model.

    Returns one row per anchor: ``{workload, name, model, paper,
    rel_err, tol, within_tol}``; :func:`assert_anchors` gates every
    ``within_tol``.
    """
    anchors = [
        ("hp", "speedup_vs_node_gpu",
         energy.PAPER_ANCHORS["hp"]["speedup_vs_node_gpu"]),
        ("hp", "energy_gain_vs_node_gpu",
         energy.PAPER_ANCHORS["hp"]["energy_gain_vs_node_gpu"]),
        ("lorenz96", "speed_gain_vs_node_gpu",
         energy.PAPER_ANCHORS["lorenz96"]["speed_gain"]["node_gpu"]),
        ("lorenz96", "energy_gain_vs_node_gpu",
         energy.PAPER_ANCHORS["lorenz96"]["energy_gain"]["node_gpu"]),
    ]
    by_workload = {w.name: _workload_ratios(w) for w in WORKLOADS}
    rows = []
    for wname, aname, paper in anchors:
        speed, egain = by_workload[wname]
        model = speed if "speed" in aname else egain
        rel = abs(model - paper) / paper
        rows.append({"workload": wname, "name": aname,
                     "model": float(model), "paper": float(paper),
                     "rel_err": float(rel), "tol": tol,
                     "within_tol": bool(rel <= tol)})
    return rows


def assert_anchors(rows: Optional[list] = None) -> list:
    """Raise if any paper anchor drifts outside its tolerance."""
    rows = anchor_rows() if rows is None else rows
    bad = [r for r in rows if not r["within_tol"]]
    if bad:
        detail = "; ".join(
            f"{r['workload']}/{r['name']}: model {r['model']:.2f} vs "
            f"paper {r['paper']:.2f} ({r['rel_err']:.1%} > {r['tol']:.0%})"
            for r in bad)
        raise AssertionError(f"paper anchors out of tolerance: {detail}")
    return rows


# ---------------------------------------------------------------------------
# Backend rows — counted work through the projection model
# ---------------------------------------------------------------------------

def _build_twin(w: Workload, hidden: Optional[int] = None,
                n_steps: Optional[int] = None, *, device=None):
    """Twin + params + uniform time grid + y0 for a workload (optionally
    at a reduced size — tests use small plumbing sizes, the card the
    paper's), on ``device`` (default cuda).  The weights are He-init from
    a CPU generator seeded 0, so a seed gives the same twin on every
    device."""
    from repro_torch.core.twin import make_autonomous_twin, make_driven_twin
    device = resolve_device(device)
    hidden = w.hidden if hidden is None else hidden
    n_steps = w.n_steps if n_steps is None else n_steps
    n_hid = w.n_layers - 1
    if w.drive_dim:
        twin = make_driven_twin(w.state_dim,
                                drive=lambda t: torch.sin(2.0 * t),
                                hidden=hidden, n_hidden_layers=n_hid)
    else:
        twin = make_autonomous_twin(w.state_dim, hidden=hidden,
                                    n_hidden_layers=n_hid)
    params = twin.init(torch.Generator().manual_seed(0), device=device)
    ts = torch.linspace(0.0, 1.0, n_steps + 1, device=device)
    y0 = torch.zeros((w.state_dim,), dtype=torch.float32, device=device)
    return twin, params, ts, y0


def measure_backend(backend_name: str, w: Workload, *,
                    hidden: Optional[int] = None,
                    n_steps: Optional[int] = None, device=None) -> dict:
    """Run one rollout on a substrate and count what it executes.

    ``program`` runs once outside the count (deployment is one-time, like
    writing a physical array), then ``rollout`` runs under a
    :class:`repro_torch.kernels.work.WorkCounter` (the fused substrates
    with ``gradient="stopgrad"``, as JAX's measures them).  Returns
    ``flops``, ``macs`` (= flops / 2), ``traffic_bytes`` and ``kernels``
    (calls per reporting kernel).  ``traffic_bytes`` is the bytes the
    kernels report (each operand read once, the result written once, as
    HLO counts a custom call's) when the whole rollout is kernel calls,
    and None where plain aten operations run: the flop counter counts no
    bytes, so there the port has no count with the meaning of JAX's.
    """
    from repro_torch.core.backends import FusedCudaBackend, resolve_backend

    be = resolve_backend(backend_name)
    twin, params, ts, y0 = _build_twin(w, hidden, n_steps, device=device)
    state = be.program(twin.node.field, params)
    grad = "stopgrad" if isinstance(be, FusedCudaBackend) else "direct"
    with torch.no_grad(), work.WorkCounter() as wc:
        be.rollout(state, y0, ts, gradient=grad)
    only_kernels = wc.aten_flops == 0.0 and bool(wc.kernels)
    return {"flops": wc.flops, "macs": wc.flops / 2.0,
            "traffic_bytes": wc.kernel_bytes if only_kernels else None,
            "kernels": {k: v.calls for k, v in wc.kernels.items()}}


def backend_rows(workloads: Sequence[Workload] = WORKLOADS,
                 backends: Sequence[str] = tuple(BACKEND_SUBSTRATE),
                 *, hidden: Optional[int] = None,
                 n_steps: Optional[int] = None,
                 measure: bool = True, device=None) -> list:
    """Per-(workload, backend) scorecard rows.

    Each row carries the substrate class, the projected per-trajectory
    ``time_us``/``energy_uj`` (digital: from counted MACs through
    :func:`energy.project_from_macs`; analogue: from array physics),
    the analytic MAC count, and — when ``measure`` — the rollout's
    counted work under ``"counted"`` (``macs``, ``flops``,
    ``traffic_bytes``, ``kernels``; :func:`measure_backend`, on
    ``device``, default cuda).  ``hidden``/``n_steps`` override the
    workload size for *both* measurement and projection (test plumbing
    runs small).
    """
    rows = []
    for w in workloads:
        if hidden is not None or n_steps is not None:
            w = dataclasses.replace(w, hidden=hidden or w.hidden,
                                    n_steps=n_steps or w.n_steps)
        for name in backends:
            substrate = BACKEND_SUBSTRATE[name]
            row = {"workload": w.name, "backend": name,
                   "substrate": substrate,
                   "hidden": w.hidden, "n_steps": w.n_steps,
                   "model_macs": w.macs_per_trajectory()}
            if measure:
                row["counted"] = measure_backend(name, w, device=device)
            if substrate == "digital":
                macs = (row["counted"]["macs"] if measure
                        else row["model_macs"])
                t_us, e_uj = energy.project_from_macs(
                    "node_gpu", macs, w.hidden, w.n_steps)
            else:
                # array physics: settling + peripheral/array power; the
                # simulator's counted MACs (2x the analytic count — the
                # differential pair) stay in the row for transparency
                t_us, e_uj = energy.project(
                    "analogue_node", w.hidden, in_dim=w.in_dim,
                    out_dim=w.out_dim, n_layers=w.n_layers,
                    n_steps=w.n_steps)
            row["projected"] = {"time_us": float(t_us),
                                "energy_uj": float(e_uj)}
            rows.append(row)
    return rows


def scorecard(*, measure: bool = True,
              backends: Sequence[str] = tuple(BACKEND_SUBSTRATE),
              hidden: Optional[int] = None,
              n_steps: Optional[int] = None, device=None) -> dict:
    """The full scorecard: anchor rows + per-backend projection rows."""
    return {"anchors": anchor_rows(),
            "backends": backend_rows(backends=backends, hidden=hidden,
                                     n_steps=n_steps, measure=measure,
                                     device=device)}
