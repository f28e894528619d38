"""Projected speed / energy model (port of ``repro/core/energy.py``) —
reproduces the paper's Fig. 3k,l and Fig. 4h,i comparisons between the
analogue memristive neural-ODE solver and digital (GPU) baselines.

The port keeps its own copy of the JAX package's pure-Python model, so it
imports nothing of ``repro``; the numbers are the same bits.

Two layers of fidelity:

1. ``PAPER_ANCHORS`` — numbers the paper reports verbatim.
2. A parametric projection model whose constants were *calibrated from
   the anchors themselves* (they are mutually consistent to ~10%):

   * digital time  = macs * T_MAC + evals * T_EVAL (+ fevals * T_SOLVER for
     the ODE solver's per-step framework overhead).  T_MAC = 0.205 ps/MAC
     reproduces the paper's LSTM/GRU/RNN times at h=512 to <1%.
   * digital energy = macs * e_mac(h), with the utilisation-dependent
     e_mac(h) = 5530/h - 3.1 pJ — this single curve reproduces the
     paper's 705.4 uJ (NODE h=64), 176.4 uJ (ResNet h=64) and the h=512
     energy ratios to ~15%.
   * analogue time = steps * stages * T_SETTLE with stages = crossbar
     layers + 1 (the IVP integrator); T_SETTLE = 5.57 ns puts the
     paper's 40.1 us (Lorenz96, 1800 steps x 4 stages) exactly on the
     line and the HP point within 17%.
   * analogue energy = (P_base + P_int*n_integrators + V^2*G*cells) * t;
     P_base = 1.4 W, P_int = 0.134 W (discrete op-amp board) reproduces
     17.0 uJ (HP) exactly and the Lorenz96 energy-gain column to <=17%.

Tests assert the model hits every anchor within 20% (most are <6%).

The analogue-side constants are replaceable with measured values
(hardware in the loop): :class:`EnergyConstants` carries them,
:func:`constants_from_calibration` loads them from the same JSON
measurement file as ``repro_torch.core.analogue.spec_from_calibration``, and
``project(..., constants=...)`` projects with the characterised device
instead of the paper-calibrated defaults.
"""
from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Paper-reported anchors (verbatim from the text)
# ---------------------------------------------------------------------------

PAPER_ANCHORS = {
    # HP memristor twin, hidden size 64 (Fig. 3k,l)
    "hp": {
        "speedup_vs_node_gpu": 4.2,
        "energy_uj": {"analogue_node": 17.0,
                      "resnet_gpu": 176.4,
                      "node_gpu": 705.4},
        "energy_gain_vs_node_gpu": 41.4,
        "energy_gain_vs_resnet_gpu": 10.4,
    },
    # Lorenz96 twin, hidden size 512 (Fig. 4h,i)
    "lorenz96": {
        "time_us": {"node_gpu": 505.8, "lstm_gpu": 392.5, "gru_gpu": 294.9,
                    "rnn_gpu": 98.8, "analogue_node": 40.1},
        "speed_gain": {"node_gpu": 12.6, "lstm_gpu": 9.8,
                       "gru_gpu": 7.4, "rnn_gpu": 2.5},
        "energy_gain": {"node_gpu": 189.7, "lstm_gpu": 147.2,
                        "gru_gpu": 100.6, "rnn_gpu": 37.1},
    },
}

# ---------------------------------------------------------------------------
# Calibrated constants (see module docstring for provenance)
# ---------------------------------------------------------------------------

T_MAC_US = 2.05e-7        # us per MAC (digital, small-batch effective)
T_EVAL_US = 5.6e-4        # us per network evaluation (launch overhead)
T_SOLVER_US = 1.85e-2     # us per ODE f-eval (solver framework overhead)
E_MAC_A_PJ = 5530.0       # e_mac(h) = A/h + B  (utilisation curve)
E_MAC_B_PJ = -3.1
E_MAC_FLOOR_PJ = 0.5
T_SETTLE_US = 5.57e-3     # analogue per-stage loop settling
P_BASE_W = 1.4            # analogue peripheral board power, fixed part
P_INT_W = 0.134           # per IVP-integrator channel power
V_READ = 0.1              # V (inference read amplitude, calibrated)
G_MEAN_S = 30e-6          # mean device conductance incl. parked G_min pairs

@dataclasses.dataclass(frozen=True)
class EnergyConstants:
    """The analogue-side constants of the projection model, as one
    swappable value object.  Defaults are the paper-calibrated numbers
    above; :func:`constants_from_calibration` fills them from a measured
    device file instead."""

    t_settle_us: float = T_SETTLE_US
    p_base_w: float = P_BASE_W
    p_int_w: float = P_INT_W
    v_read: float = V_READ
    g_mean_s: float = G_MEAN_S

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or not v > 0:
                raise ValueError(
                    f"EnergyConstants.{f.name} must be a number > 0, "
                    f"got {v!r}")


DEFAULT_CONSTANTS = EnergyConstants()


def constants_from_calibration(source) -> EnergyConstants:
    """Measured :class:`EnergyConstants` from a calibration JSON file (or
    parsed dict) — the ``energy`` section of the schema validated by
    :func:`repro_torch.core.analogue.load_calibration`.  Fields absent from
    the file keep the paper-calibrated defaults; validation errors name the
    offending field."""
    from repro_torch.core.analogue import load_calibration
    cal = load_calibration(source)
    return EnergyConstants(**cal.get("energy", {}))


SYSTEMS = ("analogue_node", "node_gpu", "resnet_gpu", "lstm_gpu", "gru_gpu",
           "rnn_gpu")
_GATES = {"lstm_gpu": 4.0, "gru_gpu": 3.0, "rnn_gpu": 1.0, "resnet_gpu": 1.0}


def _mlp_macs(sizes) -> float:
    return float(sum(a * b for a, b in zip(sizes[:-1], sizes[1:])))


def _recurrent_macs(hidden: int, in_dim: int, gates: float) -> float:
    return gates * hidden * (hidden + in_dim)


def _e_mac_pj(hidden: int) -> float:
    return max(E_MAC_A_PJ / hidden + E_MAC_B_PJ, E_MAC_FLOOR_PJ)


def project_from_macs(system: str, macs: float, hidden: int, n_steps: int):
    """Project (time_us, energy_uj) for a *digital* system from a MAC
    count — the bridge between this calibrated model and measured op
    counts (:mod:`repro_torch.core.scorecard` feeds the MACs a rollout
    executes, as :mod:`repro_torch.kernels.work` counts them, straight in
    here).

    ``macs`` is the whole-trajectory count; ``hidden`` only sets the
    utilisation-dependent energy per MAC; ``n_steps`` sets the per-step
    launch/framework overhead (``node_gpu`` additionally pays the ODE
    solver's per-f-eval overhead, 4 per RK4 step).
    """
    if system == "analogue_node":
        raise ValueError(
            "project_from_macs models digital substrates only — analogue "
            "time/energy follow array physics, not MAC counts; use "
            "project()")
    t_us = macs * T_MAC_US + n_steps * T_EVAL_US
    if system == "node_gpu":
        t_us += 4 * n_steps * T_SOLVER_US
    e_uj = macs * _e_mac_pj(hidden) * 1e-6
    return t_us, e_uj


def project(system: str, hidden: int, in_dim: int = 2, out_dim: int = 1,
            n_layers: int = 3, n_steps: int = 500,
            constants: EnergyConstants | None = None):
    """Project (time_us, energy_uj) for one inference trajectory.

    ``n_layers`` counts weight matrices (HP twin: 3; Lorenz96 twin: 4).
    ``n_steps``: trajectory length (HP: 500; Lorenz96 interpolation: 1800).
    ``constants`` swaps in measured analogue-side constants
    (:func:`constants_from_calibration`); digital systems ignore it.
    """
    sizes = [in_dim] + [hidden] * (n_layers - 1) + [out_dim]
    if system == "analogue_node":
        c = DEFAULT_CONSTANTS if constants is None else constants
        # stages = crossbar layers + the IVP-integrator stage
        t_us = n_steps * (n_layers + 1) * c.t_settle_us
        cells = 2.0 * _mlp_macs(sizes)
        p_array_w = cells * c.v_read ** 2 * c.g_mean_s
        p_w = c.p_base_w + c.p_int_w * out_dim + p_array_w
        e_uj = p_w * t_us
        return t_us, e_uj
    if system == "node_gpu":
        macs = _mlp_macs(sizes) * 4 * n_steps        # RK4: 4 f-evals/step
    elif system == "resnet_gpu":
        macs = _mlp_macs(sizes) * n_steps            # one block/step
    elif system in _GATES:
        macs = _recurrent_macs(hidden, in_dim, _GATES[system]) * n_steps
    else:
        raise ValueError(f"unknown system {system!r}")
    return project_from_macs(system, macs, hidden, n_steps)


def gains_table(hidden_sizes, **kw):
    """Speed/energy gain of the analogue system vs each digital baseline."""
    rows = []
    for h in hidden_sizes:
        t_a, e_a = project("analogue_node", h, **kw)
        row = {"hidden": h, "analogue_time_us": t_a, "analogue_energy_uj": e_a}
        for sys in SYSTEMS[1:]:
            t_d, e_d = project(sys, h, **kw)
            row[f"{sys}_time_us"] = t_d
            row[f"{sys}_energy_uj"] = e_d
            row[f"{sys}_speed_gain"] = t_d / t_a
            row[f"{sys}_energy_gain"] = e_d / e_a
        rows.append(row)
    return rows


def hp_projection():
    """HP twin at hidden 64 (Fig. 3k,l configuration)."""
    return gains_table([8, 16, 32, 64], in_dim=2, out_dim=1, n_layers=3,
                       n_steps=500)


def lorenz96_projection():
    """Lorenz96 twin (Fig. 4h,i: three-layer net per Methods, 1800 steps)."""
    return gains_table([64, 128, 256, 512], in_dim=6, out_dim=6, n_layers=3,
                       n_steps=1800)
