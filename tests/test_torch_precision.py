"""The port's bf16 precision policies against JAX, on the CPU.

``"bf16_f32acc"`` and ``"bf16"`` of K1, K2, K5 and K6 (their plain
versions here; the kernels are held to the same plain versions on the
card by ``chip_smoke.py`` phase 25), the rounding-chunk planners, and the
policy threaded through ``FusedCudaBackend``, fused training and the fleet
CLI.  The JAX kernels run in interpret mode, as the JAX package's own
tests run them; inputs are made from seeds with numpy.

Tolerances:
- the plain rollout is JAX's bit for bit at the two cases below, under
  both policies, at an explicit chunk and at the planners' (bf16 x bf16
  products are exact in float32, and these float32 sums round alike);
- gradients: JAX rounds each batch tile's per-step weight cotangent to
  bf16 (2^-9 relative) and sums its four stages in bf16 before adding it
  to its float32 accumulator, which the port does not (it sums in float32,
  so its gradient does not depend on a batch tile): 1e-2 of each
  gradient's peak (~5 such roundings); dy0 has no such rounding and is
  equal;
- backends: JAX's and the port's drive grids differ by an ulp in
  interior points (``half_step_drive``), which can flip a bf16 rounding
  of a drive sample: 2^-7 of the peak (one bf16 ulp);
- soft-DTW: the f32 slice's tolerances (1e-5 values, 1e-4 gradients of
  the peak, ``tests/test_torch_softdtw.py``) on the same bf16 costs;
- loss histories: 1e-3 rel per step, the f32 training parity tests'.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import twin as jtwin  # noqa: E402
from repro.core.backends import FusedPallasBackend  # noqa: E402
from repro.data import hp_memristor as jhp  # noqa: E402
from repro.kernels import fused_ode_mlp as jk  # noqa: E402
from repro.kernels import fused_ode_mlp_bwd as jk2  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.core import twin as ttwin  # noqa: E402
from repro_torch.core.backends import (FusedAnalogueCudaBackend,  # noqa: E402
                                       FusedCudaBackend)
from repro_torch.data import hp_memristor as thp  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import fused_ode_mlp as tk  # noqa: E402
from repro_torch.kernels import fused_ode_mlp_bwd as tk2  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import work  # noqa: E402
from repro_torch.launch import fleet_serving as tfleet  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

POLICIES = ("bf16_f32acc", "bf16")
GRAD_TOL = 1e-2
BACKEND_TOL = 2.0 ** -7

#: The two cases of the CPU rehearsal: (sizes, B, T, drive, dt, batch_tile).
CASES = {
    "hp": ((2, 14, 14, 1), 8, 50, "per_twin", 0.05, 4),
    "l96": ((6, 64, 64, 6), 8, 60, "autonomous", 0.01, 8),
}


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


def make_inputs(seed, sizes, B, T, mode):
    """He-init weights with random biases, y0 and a drive, numpy f32."""
    rng = np.random.default_rng(seed)
    ws = [(rng.standard_normal((a, b)) * np.sqrt(2.0 / a)).astype(np.float32)
          for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [(0.1 * rng.standard_normal(b)).astype(np.float32)
          for b in sizes[1:]]
    D = sizes[-1]
    y0 = (0.5 * rng.standard_normal((B, D))).astype(np.float32)
    th = np.linspace(0.0, 1.0, 2 * T + 1)
    if mode == "autonomous":
        u = np.zeros((2 * T + 1, 0), np.float32)
    else:
        amp = rng.uniform(0.5, 1.5, (B, 1))
        freq = rng.uniform(1.0, 4.0, (B, 1))
        u = (amp * np.sin(2 * np.pi * freq * th[None]))[..., None]
    return y0, u.astype(np.float32), ws, bs


def as_f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# the planners
# ---------------------------------------------------------------------------

PLAN_GRID = [(sizes, T, bt, per_tile, tc)
             for sizes, per_tile in (((2, 14, 14, 1), True),
                                     ((2, 14, 14, 1), False),
                                     ((6, 64, 64, 6), False),
                                     ((6, 512, 512, 6), False))
             for T in (1, 50, 1800, 100_000)
             for bt in (1, 9, 64)
             for tc in (None, 7, 10 ** 6)]


@pytest.mark.parametrize("precision", ["f32", *POLICIES])
def test_planners_equal_jax(precision):
    """plan_time_chunk and plan_bwd_time_chunk over widths, horizons, tiles
    and explicit chunks: the port's ChunkPlan is JAX's, and where JAX's
    planner refuses, the port's raises too."""
    for sizes, T, bt, per_tile, tc in PLAN_GRID:
        ws = [jnp.zeros((a, b)) for a, b in zip(sizes[:-1], sizes[1:])]
        bs = [jnp.zeros((b,)) for b in sizes[1:]]
        D, du = sizes[-1], sizes[0] - sizes[-1]
        for jplan, tplan in ((jk.plan_time_chunk, tk.plan_time_chunk),
                             (jk2.plan_bwd_time_chunk,
                              tk2.plan_bwd_time_chunk)):
            try:
                want = jplan(T, bt, D, du, per_tile, ws, bs,
                             jk.DEFAULT_VMEM_BUDGET, tc, precision=precision)
            except ValueError:
                with pytest.raises(ValueError, match="VMEM"):
                    tplan(T, bt, D, du, per_tile, sizes,
                          tk.DEFAULT_VMEM_BUDGET, tc, precision)
                continue
            got = tplan(T, bt, D, du, per_tile, sizes,
                        tk.DEFAULT_VMEM_BUDGET, tc, precision)
            assert tuple(got) == tuple(want), (sizes, T, bt, tc)


def test_policy_surface():
    assert tk.PRECISIONS == jk.PRECISIONS
    assert tk.default_precision() == "f32"
    assert tk.resolve_precision(None) == "f32"
    for p in jk.PRECISIONS:
        assert tk.resolve_precision(p) == p
        want = [jnp.dtype(d).itemsize for d in jk.precision_dtypes(p)]
        assert [d.itemsize for d in tk.precision_dtypes(p)] == want
    assert tk.precision_dtypes("bf16_f32acc") == (
        torch.bfloat16, torch.bfloat16, torch.float32, torch.float32)
    with pytest.raises(ValueError, match="unknown precision"):
        tk.precision_dtypes("fp8")


# ---------------------------------------------------------------------------
# the plain rollout, bitwise JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("precision", POLICIES)
def test_plain_rollout_is_jax_bitwise(case, precision):
    """At an explicit chunk of 7 (K1's wrapper), and at the planners'
    chunk through ``ops.fused_node_rollout`` for "stopgrad" (the forward
    planner) and "fused_vjp" (the backward planner's shared chunk)."""
    sizes, B, T, mode, dt, bt = CASES[case]
    y0, u, ws, bs = make_inputs(3, sizes, B, T, mode)
    want = jk.fused_node_rollout(
        jnp.asarray(y0), jnp.asarray(u), [jnp.asarray(w) for w in ws],
        [jnp.asarray(b) for b in bs], dt, batch_tile=bt, time_chunk=7,
        interpret=True, precision=precision)
    got = tk.fused_node_rollout(t(y0), t(u), [t(w) for w in ws],
                                [t(b) for b in bs], dt, batch_tile=bt,
                                time_chunk=7, precision=precision)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), as_f32(want))
    jp = [{"w": jnp.asarray(w), "b": jnp.asarray(b)} for w, b in zip(ws, bs)]
    tp = [{"w": t(w), "b": t(b)} for w, b in zip(ws, bs)]
    for gradient in ("stopgrad", "fused_vjp"):
        want = jops.fused_node_rollout(jp, jnp.asarray(y0), jnp.asarray(u),
                                       dt, batch_tile=bt, interpret=True,
                                       gradient=gradient, precision=precision)
        got = tops.fused_node_rollout(tp, t(y0), t(u), dt, batch_tile=bt,
                                      gradient=gradient, precision=precision)
        np.testing.assert_array_equal(got.detach().float().numpy(),
                                      as_f32(want))


def test_f32_time_chunk_changes_no_bit():
    sizes, B, T, mode, dt, bt = CASES["hp"]
    y0, u, ws, bs = make_inputs(4, sizes, B, T, mode)
    tp = [{"w": t(w).requires_grad_(), "b": t(b).requires_grad_()}
          for w, b in zip(ws, bs)]
    outs, grads = [], []
    for tc in (None, 1, 7, T):
        out = tops.fused_node_rollout(tp, t(y0), t(u), dt, batch_tile=bt,
                                      time_chunk=tc, precision="f32")
        outs.append(out.detach())
        grads.append(torch.autograd.grad((out ** 2).sum(),
                                         [p["w"] for p in tp]))
    for out, g in zip(outs[1:], grads[1:]):
        assert out.dtype == torch.float32
        assert torch.equal(out, outs[0])
        assert all(torch.equal(a, b) for a, b in zip(g, grads[0]))


@pytest.mark.parametrize("precision", POLICIES)
def test_resume_and_autograd_forward_are_bitwise(precision):
    """A resume from row k C with the drive window reproduces rows k C..T;
    the forward inside autograd is a plain call with the shared chunk."""
    sizes, B, T, mode, dt, bt = CASES["hp"]
    y0, u, ws, bs = make_inputs(5, sizes, B, T, mode)
    W, Bs = [t(w) for w in ws], [t(b) for b in bs]
    C, k = 7, 3
    full = tk.fused_node_rollout(t(y0), t(u), W, Bs, dt, batch_tile=bt,
                                 time_chunk=C, precision=precision)
    rest = tk.fused_node_rollout(full[k * C], tk.drive_window(
        t(u), k * C, T - k * C), W, Bs, dt, batch_tile=bt, time_chunk=C,
        precision=precision)
    assert torch.equal(rest, full[k * C:])
    tp = [{"w": w.clone().requires_grad_(), "b": b.clone().requires_grad_()}
          for w, b in zip(W, Bs)]
    fwd = tops.fused_node_rollout(tp, t(y0), t(u), dt, batch_tile=bt,
                                  precision=precision)
    C_shared = tk2.shared_chunk(t(y0), t(u), sizes, bt, None, precision)
    plain = tk.fused_node_rollout(t(y0), t(u), W, Bs, dt, batch_tile=bt,
                                  time_chunk=C_shared, precision=precision)
    assert torch.equal(fwd.detach(), plain)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

def test_bf16_f32acc_gradients_match_jax():
    """JAX's HP setup (``tests/test_gradients.py``: T 23, B 8, batch_tile
    4, time_chunk 5, mean(traj^2)): float32 gradients within GRAD_TOL of
    JAX's, dy0 equal, and within 2e-2 of the port's f32 gradients."""
    rng = np.random.default_rng(21)
    sizes = (2, 14, 14, 1)
    ws = [(rng.standard_normal((a, b)) * np.sqrt(2.0 / a)).astype(np.float32)
          for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [(0.1 * rng.standard_normal(b)).astype(np.float32)
          for b in sizes[1:]]
    T, B = 23, 8
    ts = np.linspace(0.0, 0.23, T + 1).astype(np.float32)
    th = np.linspace(0.0, 0.23, 2 * T + 1).astype(np.float32)
    uh = np.sin(4 * th)[:, None].astype(np.float32)
    y0 = (0.3 * rng.standard_normal((B, 1))).astype(np.float32)
    dt = float(ts[1] - ts[0])

    def jloss(p, y):
        traj = jops.fused_node_rollout(p, y, jnp.asarray(uh), dt,
                                       batch_tile=4, time_chunk=5,
                                       precision="bf16_f32acc")
        return jnp.mean(traj.astype(jnp.float32) ** 2)

    jp = [{"w": jnp.asarray(w), "b": jnp.asarray(b)} for w, b in zip(ws, bs)]
    jg, jgy = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(y0))
    want = [np.asarray(g[k]) for g in jg for k in ("w", "b")]

    def tgrads(precision):
        tp = [{"w": t(w).requires_grad_(), "b": t(b).requires_grad_()}
              for w, b in zip(ws, bs)]
        ty = t(y0).requires_grad_()
        traj = tops.fused_node_rollout(tp, ty, t(uh), dt, batch_tile=4,
                                       time_chunk=5, precision=precision)
        torch.mean(traj.float() ** 2).backward()
        return [p[k].grad for p in tp for k in ("w", "b")], ty.grad

    got, gy = tgrads("bf16_f32acc")
    got32, _ = tgrads("f32")
    assert all(g.dtype == torch.float32 for g in got) and gy.dtype == torch.float32
    np.testing.assert_array_equal(gy.numpy(), np.asarray(jgy))
    for g, w, g32 in zip(got, want, got32):
        assert rel(g.numpy(), w) <= GRAD_TOL
        assert rel(g.numpy(), g32.numpy()) <= 2e-2


@pytest.mark.parametrize("precision", POLICIES)
def test_soft_dtw_policies_match_jax(precision):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 40, 2)).astype(np.float32)
    y = rng.standard_normal((2, 60, 2)).astype(np.float32)
    jv, jg = jax.value_and_grad(
        lambda a, b: jnp.sum(jops.soft_dtw(a, b, 0.5, True, precision)),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx, ty = t(x).requires_grad_(), t(y).requires_grad_()
    tv = tops.soft_dtw(tx, ty, 0.5, precision=precision)
    assert tv.dtype == torch.float32
    tv.sum().backward()
    assert float(tv.detach().sum()) == pytest.approx(float(jv), rel=1e-5)
    assert rel(tx.grad.numpy(), jg[0]) <= 1e-4
    assert rel(ty.grad.numpy(), jg[1]) <= 1e-4


# ---------------------------------------------------------------------------
# the wiring: backend, training, CLI, reported work, refusals
# ---------------------------------------------------------------------------

def hp_twins():
    drive = (jhp.WAVEFORMS["sine"](amp=2.0, freq=2.0),
             thp.WAVEFORMS["sine"](amp=2.0, freq=2.0))
    return (jtwin.make_driven_twin(1, drive[0], hidden=14),
            ttwin.make_driven_twin(1, drive[1], hidden=14))


def np_params(seed, sizes):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / a))
             .astype(np.float32),
             "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
            for a, b in zip(sizes[:-1], sizes[1:])]


@pytest.mark.parametrize("precision", POLICIES)
def test_backend_simulate_matches_fused_pallas(precision):
    """``FusedCudaBackend(precision=)`` against ``FusedPallasBackend``'s
    simulate; the trajectory is bf16, the staged weights stay float32
    masters, and the per-call override is the policy's backend bitwise."""
    jt, tt = hp_twins()
    p = np_params(8, (2, 14, 14, 1))
    ts = np.linspace(0.0, 0.25, 51).astype(np.float32)
    y0 = np.array([0.2], np.float32)
    want = jt.with_backend(FusedPallasBackend(batch_tile=1,
                                              precision=precision)).simulate(
        [{k: jnp.asarray(v) for k, v in q.items()} for q in p],
        jnp.asarray(y0), jnp.asarray(ts))
    tp = params_from_numpy(p, "cpu")
    be = FusedCudaBackend(batch_tile=1, precision=precision)
    got = tt.with_backend(be).simulate(tp, t(y0), t(ts))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert rel(got.float().numpy(), as_f32(want)) <= BACKEND_TOL
    state = be.program(tt.field, tp)
    assert all(w.dtype == torch.float32 for w in state.extra["weights"])
    f32 = tt.with_backend(FusedCudaBackend(batch_tile=1)).simulate(
        tp, t(y0), t(ts))
    over = be.rollout(state, t(y0), t(ts), precision="f32")
    assert over.dtype == torch.float32 and torch.equal(over, f32)
    be32 = FusedCudaBackend(batch_tile=1)
    again = be32.rollout(be32.program(tt.field, tp), t(y0), t(ts),
                         precision=precision)
    assert torch.equal(again, got)
    # the analogue substrate ignores the policy, as the JAX package's does
    ab = FusedAnalogueCudaBackend(batch_tile=1, precision=precision)
    aout = tt.with_backend(ab).simulate(tp, t(y0), t(ts))
    assert aout.dtype == torch.float32


@pytest.mark.parametrize("loss", ["l1", "l1+softdtw"])
def test_train_twin_bf16_f32acc_history_matches_jax(loss):
    """5 steps of fused training at bf16_f32acc from the same params: the
    port's loss history (K1, K2, and with soft-DTW K5 / K6 on bf16 costs,
    their plain versions here) follows JAX's to 1e-3 rel per step."""
    ts, xs, _, _ = jhp.generate("sine", num_points=200, dt=1e-3, amp=2.0,
                                freq=2.0)
    ts, ys = np.asarray(ts), np.asarray(xs)[:, None]
    p = np_params(9, (2, 14, 14, 1))
    jt, tt = hp_twins()
    _, want = jtrainer.train_twin(
        jt, [{k: jnp.asarray(v) for k, v in q.items()} for q in p],
        jnp.asarray(ts), jnp.asarray(ys), optimizer=jopt.adam(1e-3),
        num_steps=5, segment_len=40, loss=loss, gamma=0.1,
        backend=FusedPallasBackend(precision="bf16_f32acc"))
    _, got = ttrainer.train_twin(
        tt, params_from_numpy(p, "cpu"), t(ts), t(ys),
        optimizer=topt.adam(1e-3), num_steps=5, segment_len=40, loss=loss,
        gamma=0.1, backend=FusedCudaBackend(precision="bf16_f32acc"))
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape == (5,)
    assert float(np.max(np.abs(got.numpy() - want) / np.abs(want))) <= 1e-3


def test_reported_bytes_follow_the_policy():
    """``rollout_work`` counts the drive, weights and trajectory at the
    storage itemsize: a bf16 rollout reports the f32 count less half of
    those bytes, and the same FLOP."""
    sizes, B, T, mode, dt, bt = CASES["hp"]
    y0, u, ws, bs = make_inputs(6, sizes, B, T, mode)
    counts = {}
    for p in ("f32", *POLICIES):
        with work.WorkCounter() as wc:
            tk.fused_node_rollout(t(y0), t(u), [t(w) for w in ws],
                                  [t(b) for b in bs], dt, batch_tile=bt,
                                  precision=p)
        counts[p] = (wc.kernels["K1"].flops, wc.kernels["K1"].nbytes)
    params = sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))
    halved = 2.0 * (u.size + params + (T + 1) * B * sizes[-1])
    assert counts["f32"] == tk.rollout_work(sizes, B, T, u.size)
    for p in POLICIES:
        assert counts[p][0] == counts["f32"][0]
        assert counts[p][1] == counts["f32"][1] - halved


def test_wide_kernel_refuses_bf16():
    """K1w (6->512->512->6, over one block) takes f32 only: a bf16 policy
    there raises, naming ROADMAP; the analogue backends, K4w's callers,
    ignore the policy as the JAX package does, so no bf16 reaches K4w."""
    sizes = (6, 512, 512, 6)
    y0, u, ws, bs = make_inputs(7, sizes, 1, 2, "autonomous")
    for p in POLICIES:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tk.fused_node_rollout(t(y0), t(u), [t(w) for w in ws],
                                  [t(b) for b in bs], 0.01, precision=p)
    out = tk.fused_node_rollout(t(y0), t(u), [t(w) for w in ws],
                                [t(b) for b in bs], 0.01, precision="f32")
    assert out.dtype == torch.float32


def test_fleet_cli_precision_flag(capsys):
    outs = tfleet.main(["--device", "cpu", "--fleet", "4", "--horizon", "3",
                        "--batches", "1", "--precision", "bf16_f32acc"])
    assert len(outs) == 1 and outs[0].dtype == torch.bfloat16
    assert "precision bf16_f32acc" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tfleet.main(["--device", "cpu", "--backend", "digital",
                     "--precision", "bf16"])
    assert "does not apply to --backend digital" in capsys.readouterr().err
