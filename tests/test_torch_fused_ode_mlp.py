"""The port's K1 wrapper (``repro_torch.kernels.fused_ode_mlp``) against JAX.

On the CPU the wrapper runs K1's plain version; these tests hold it
against the JAX package's Pallas kernel (interpret mode on the CPU) and
its jnp reference, on the same numpy-made inputs, to 1e-5 of the
trajectory's peak.  The CUDA kernel itself is held against the same
plain version on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import fused_ode_mlp as jk  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fused_ode_mlp as tk  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = 1e-5      # of the trajectory's peak |y|; measured ~1e-7 (f32 matmul order)


def make_inputs(seed, sizes, B, T, mode):
    """He-init weights with random biases, y0 and a drive, all numpy f32."""
    rng = np.random.default_rng(seed)
    ws = [(rng.standard_normal((a, b)) * np.sqrt(2.0 / a)).astype(np.float32)
          for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [(0.1 * rng.standard_normal(b)).astype(np.float32)
          for b in sizes[1:]]
    D = sizes[-1]
    du = sizes[0] - D
    y0 = (0.5 * rng.standard_normal((B, D))).astype(np.float32)
    th = np.linspace(0.0, 1.0, 2 * T + 1)
    if mode == "autonomous":
        u = np.zeros((2 * T + 1, 0), np.float32)
    elif mode == "shared":
        u = np.sin(2 * np.pi * 2.0 * th)[:, None].repeat(du, 1)
    else:
        amp = rng.uniform(0.5, 1.5, (B, 1))
        freq = rng.uniform(1.0, 4.0, (B, 1))
        u = (amp * np.sin(2 * np.pi * freq * th[None]))[..., None]
    return y0, u.astype(np.float32), ws, bs


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


CASES = {
    "l96_full_width": ((6, 64, 64, 6), 64, 200, "autonomous", 0.0025, 64),
    "autonomous_h16": ((4, 16, 16, 4), 12, 40, "autonomous", 0.01, 4),
    "shared_drive_hp": ((2, 14, 14, 1), 16, 60, "shared", 1e-2, 8),
    "per_twin_drive_hp": ((2, 14, 14, 1), 12, 40, "per_twin", 1e-2, 6),
    "one_layer": ((3, 2), 4, 30, "shared", 1e-2, 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_k1_matches_jax_pallas_and_ref(case):
    sizes, B, T, mode, dt, bt = CASES[case]
    y0, u, ws, bs = make_inputs(1, sizes, B, T, mode)
    want_kernel = np.asarray(jk.fused_node_rollout(
        jnp.asarray(y0), jnp.asarray(u), [jnp.asarray(w) for w in ws],
        [jnp.asarray(b) for b in bs], dt, batch_tile=bt, precision="f32"))
    want_ref = np.asarray(jref.fused_node_rollout_ref(
        jnp.asarray(y0), jnp.asarray(u), [jnp.asarray(w) for w in ws],
        [jnp.asarray(b) for b in bs], dt))
    got = tk.fused_node_rollout(t(y0), t(u), [t(w) for w in ws],
                                [t(b) for b in bs], dt, batch_tile=bt)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want_kernel.shape == (T + 1, B, sizes[-1])
    np.testing.assert_array_equal(got[0].numpy(), y0)
    assert rel(got.numpy(), want_kernel) <= TOL
    assert rel(got.numpy(), want_ref) <= TOL


@pytest.mark.parametrize("mode", ["autonomous", "per_twin"])
def test_fleet_not_a_tile_multiple_pads_like_jax(mode):
    sizes = (2, 14, 14, 1) if mode == "per_twin" else (6, 16, 16, 6)
    B, T, bt, dt = 10, 30, 4, 1e-2
    y0, u, ws, bs = make_inputs(2, sizes, B, T, mode)
    jy, ju, jbt, jB = jk.pad_fleet_to_tile(jnp.asarray(y0), jnp.asarray(u), bt)
    ty, tu, tbt, tB = tk.pad_fleet_to_tile(t(y0), t(u), bt)
    assert (tbt, tB) == (jbt, jB) == (4, 10)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    assert ty.shape[0] == 12
    with pytest.raises(ValueError, match="not divisible by tile"):
        tk.fused_node_rollout(t(y0), t(u), [t(w) for w in ws],
                              [t(b) for b in bs], dt, batch_tile=bt)
    want = np.asarray(jk.fused_node_rollout(
        jy, ju, [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs],
        dt, batch_tile=jbt, precision="f32"))[:, :jB]
    got = tk.fused_node_rollout(ty, tu, [t(w) for w in ws],
                                [t(b) for b in bs], dt, batch_tile=tbt)[:, :tB]
    assert rel(got.numpy(), want) <= TOL


def test_ops_rollout_matches_jax_ops():
    sizes, B, T, dt = (2, 14, 14, 1), 8, 50, 1e-2
    y0, u, ws, bs = make_inputs(3, sizes, B, T, "shared")
    jparams = [{"w": jnp.asarray(w), "b": jnp.asarray(b)} for w, b in zip(ws, bs)]
    tparams = [{"w": t(w), "b": t(b)} for w, b in zip(ws, bs)]
    want = np.asarray(jops.fused_node_rollout(
        jparams, jnp.asarray(y0), jnp.asarray(u), dt, batch_tile=8,
        gradient="stopgrad", precision="f32"))
    got = tops.fused_node_rollout(tparams, t(y0), t(u), dt, batch_tile=8,
                                  gradient="stopgrad")
    assert rel(got.numpy(), want) <= TOL
    # on CPU tensors the wrapper IS the plain version
    np.testing.assert_array_equal(
        got.numpy(),
        tref.fused_node_rollout_ref(t(y0), t(u), [t(w) for w in ws],
                                    [t(b) for b in bs], dt).numpy())


def test_drive_window_matches_jax():
    u = np.arange(3 * 21 * 2, dtype=np.float32).reshape(3, 21, 2)
    for start, n in [(0, 10), (3, 4), (9, 1)]:
        np.testing.assert_array_equal(
            tk.drive_window(t(u), start, n).numpy(),
            np.asarray(jk.drive_window(jnp.asarray(u), start, n)))
        np.testing.assert_array_equal(
            tk.drive_window(t(u[0]), start, n).numpy(),
            np.asarray(jk.drive_window(jnp.asarray(u[0]), start, n)))
    with pytest.raises(ValueError, match="half-step grid"):
        tk.drive_window(t(u), 8, 3)


# ---------------------------------------------------------------------------
# Time-grid helpers: byte-identical to repro.kernels.ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start", [0, 7, np.array([0, 3, 11, 250])])
def test_grid_helpers_byte_identical(start):
    t0, dt, n = 0.125, 0.0025, 37
    for name in ("window_times", "half_step_times"):
        want = np.asarray(getattr(jops, name)(t0, dt, n, start))
        got = getattr(tops, name)(t0, dt, n, start).numpy()
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes(), name
    # a drive with one exactly rounded op per sample: byte-identical too
    want = np.asarray(jops.sample_drive_window(lambda s: s * s, t0, dt, n,
                                               start))
    got = tops.sample_drive_window(lambda s: s * s, t0, dt, n, start).numpy()
    assert got.shape == want.shape and got.tobytes() == want.tobytes()


def test_half_step_drive_grid_within_an_ulp():
    # jnp.linspace's interior points follow XLA's rewrite of its
    # arithmetic, torch.linspace's its own: the grids agree to ~1 ulp,
    # with the ends exact.
    for T in (1, 20, 200):
        ts = np.linspace(0.0, T * 0.0025, T + 1).astype(np.float32)
        want = np.asarray(jops.half_step_drive(lambda s: s, jnp.asarray(ts)))
        got = tops.half_step_drive(lambda s: s, t(ts)).numpy()
        assert got.shape == want.shape == (2 * T + 1, 1)
        assert got[0] == want[0] and got[-1] == want[-1]
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2 * np.finfo(np.float32).eps * ts[-1])
    ts = np.linspace(0.0, 0.5, 51).astype(np.float32)
    np.testing.assert_allclose(
        tops.half_step_drive(lambda s: torch.sin(3 * s), t(ts)).numpy(),
        np.asarray(jops.half_step_drive(lambda s: jnp.sin(3 * s),
                                        jnp.asarray(ts))), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# Errors, named like the JAX package's
# ---------------------------------------------------------------------------

def _l96_inputs():
    y0, u, ws, bs = make_inputs(4, (6, 16, 16, 6), 4, 5, "autonomous")
    return t(y0), t(u), [t(w) for w in ws], [t(b) for b in bs]


@pytest.mark.parametrize("which,name", [
    ("y0", "y0"), ("u_half", "u_half"), ("w1", "weights[1]"),
    ("b0", "biases[0]")])
def test_non_floating_input_names_itself(which, name):
    y0, u, ws, bs = _l96_inputs()
    if which == "y0":
        y0 = y0.to(torch.int32)
    elif which == "u_half":
        u = u.to(torch.int64)
    elif which == "w1":
        ws[1] = ws[1].to(torch.int32)
    else:
        bs[0] = bs[0].to(torch.int32)
    with pytest.raises(ValueError, match=rf"{name.replace('[', '.').replace(']', '.')} has non-floating"):
        tk.fused_node_rollout(y0, u, ws, bs, 0.01, batch_tile=4)


def test_ops_names_the_param_dict_entry():
    y0, u, ws, bs = _l96_inputs()
    params = [{"w": w, "b": b} for w, b in zip(ws, bs)]
    params[2]["w"] = params[2]["w"].to(torch.int32)
    with pytest.raises(ValueError, match=r"params\[2\]\['w'\] has non-floating"):
        tops.fused_node_rollout(params, y0, u, 0.01, batch_tile=4,
                                gradient="stopgrad")


def test_per_twin_drive_batch_mismatch_raises():
    y0, _, ws, bs = make_inputs(5, (2, 14, 14, 1), 6, 5, "per_twin")
    _, u, _, _ = make_inputs(5, (2, 14, 14, 1), 5, 5, "per_twin")
    with pytest.raises(ValueError, match="per-twin drive batch 5 != y0 batch 6"):
        tk.fused_node_rollout(t(y0), t(u), [t(w) for w in ws],
                              [t(b) for b in bs], 0.01, batch_tile=6)


def test_precision_policies():
    """f32 stays float32; both bf16 policies store the trajectory as
    bfloat16 and equal the JAX kernel (interpret mode) bit for bit on the
    same inputs; an unknown policy still raises."""
    y0, u, ws, bs = _l96_inputs()
    out = tk.fused_node_rollout(y0, u, ws, bs, 0.01, batch_tile=4,
                                precision="f32")
    assert out.dtype == torch.float32
    for p in ("bf16", "bf16_f32acc"):
        got = tk.fused_node_rollout(y0, u, ws, bs, 0.01, batch_tile=4,
                                    precision=p)
        want = jk.fused_node_rollout(
            jnp.asarray(y0.numpy()), jnp.asarray(u.numpy()),
            [jnp.asarray(w.numpy()) for w in ws],
            [jnp.asarray(b.numpy()) for b in bs], 0.01, batch_tile=4,
            precision=p, interpret=True)
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    with pytest.raises(ValueError, match="unknown precision"):
        tk.fused_node_rollout(y0, u, ws, bs, 0.01, precision="fp8")


def test_shared_memory_fit_check():
    # the Lorenz96 twin, one twin per block: the 128-word product table,
    # w_l (rows padded to 4 floats) and b_l, then two stage inputs, two
    # hidden buffers, the state and the RK4 sum, each padded to 4 floats;
    # ~21 KB, under the 48 KB static limit
    need = tk.check_smem_fit((6, 64, 64, 6))
    weights = 6 * 64 + 64 + 64 * 64 + 64 + 64 * 8 + 8
    assert need == tk.smem_bytes((6, 64, 64, 6)) == 4 * (
        128 + weights + (2 * 8 + 2 * 64 + 2 * 8))
    assert need < 48 * 1024
    # the scorecard's 6->512->512->6 (~1.07 MB of weights) cannot stay
    # resident in one block ...
    with pytest.raises(ValueError, match="227 KB"):
        tk.check_smem_fit((6, 512, 512, 6))
    # ... so the rollout takes the wide cluster kernel K1w's launch (on the
    # CPU its plain version, the same function)
    rng = np.random.default_rng(0)
    sizes = (6, 512, 512, 6)
    ws = [t((rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32))
          for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [torch.zeros(b) for b in sizes[1:]]
    y0 = t(rng.standard_normal((2, 6)).astype(np.float32))
    assert tk.launch_geometry(2, sizes).cluster == tk.WIDE_CLUSTER
    got = tk.fused_node_rollout(y0, torch.zeros(3, 0), ws, bs, 0.01)
    assert got.shape == (2, 2, 6)
    assert torch.equal(got, tref.fused_node_rollout_ref(
        y0, torch.zeros(3, 0), ws, bs, 0.01))


#: (B, sizes) of every K1 launch on the main paths: the Lorenz96 fleet
#: request, HP training (9 segments of 50), Lorenz96 training at the CI
#: and paper windows (14 and 29 segments of 60) and P4's 8 of 200.
MAIN_PATH_SHAPES = [(1024, (6, 64, 64, 6)), (9, (2, 14, 14, 1)),
                    (14, (6, 64, 64, 6)), (29, (6, 64, 64, 6)),
                    (8, (6, 64, 64, 6))]


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("B,sizes", MAIN_PATH_SHAPES)
def test_geometry_covers_the_card(B, sizes, backward):
    geom = tk.launch_geometry(B, sizes, backward=backward)
    assert geom.blocks >= min(B, tk.NUM_SMS)
    assert geom.blocks * geom.twins_per_block >= B
    assert geom.threads % 32 == 0 and 32 <= geom.threads <= tk.MAX_THREADS
    # the block has a lane for every product and (K2) holds every
    # gradient tile
    pairs = list(zip(sizes[:-1], sizes[1:]))
    lanes = [tk._matvec_lanes(a, b) for a, b in pairs]
    if backward:
        lanes += [tk._matvec_lanes(b, a) for a, b in pairs]
        assert (tk.gradient_tiles(sizes)
                <= tk.MAX_TILES_PER_THREAD * geom.threads)
    assert max(lanes) <= geom.threads


@pytest.mark.parametrize("backward", [False, True])
def test_fleet_geometry_lets_two_blocks_share_an_sm(backward):
    geom = tk.launch_geometry(1024, (6, 64, 64, 6), backward=backward)
    assert geom.twins_per_block == tk.FLEET_TWINS_PER_BLOCK
    # an H100 SM holds 2048 threads and 228 KB of shared memory, 1 KB of
    # it reserved per resident block
    assert 2 * geom.threads <= 2048
    assert 2 * (geom.smem_bytes + 1024) <= 228 * 1024


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("sizes", [(2, 14, 14, 1), (6, 64, 64, 6),
                                   (6, 128, 128, 6)])
def test_accepted_widths_fit_a_block(sizes, backward):
    for B in (1, 9, 256, 1024):
        geom = tk.launch_geometry(B, sizes, backward=backward)
        assert geom.smem_bytes <= tk.SMEM_LIMIT_BYTES
    # chip_smoke.py phase 3's wide case still needs the raised allowance
    if sizes == (6, 128, 128, 6):
        assert tk.launch_geometry(256, sizes).smem_bytes > 48 * 1024


@pytest.mark.parametrize("sizes,backward", [
    ((6, 226, 226, 6), False), ((2, 230, 230, 1), False),
    ((6, 144, 144, 6), True), ((2, 149, 149, 1), True)])
def test_widest_widths_stay_accepted(sizes, backward):
    """The widest square MLPs the one-layout-per-8-twins kernels took
    (their shared-memory formulas) still launch, at any fleet size."""
    for B in (1, 1024):
        assert (tk.launch_geometry(B, sizes, backward=backward).smem_bytes
                <= tk.SMEM_LIMIT_BYTES)


@pytest.mark.parametrize("backward", [False, True])
def test_scorecard_width_is_still_refused(backward):
    """The resident design still refuses 6->512->512->6; the forward (K1)
    now takes the wide cluster launch of K1w instead, while K2, whose
    weights and transposes stay resident, keeps its refusal."""
    sizes = (6, 512, 512, 6)
    if backward:
        with pytest.raises(ValueError, match="227 KB"):
            tk.launch_geometry(1024, sizes, backward=True)
        return
    geom = tk.launch_geometry(1024, sizes)
    assert (geom.cluster, geom.twins_per_block, geom.blocks) == (
        tk.WIDE_CLUSTER, 4, 256 * tk.WIDE_CLUSTER)
    assert geom.smem_bytes <= tk.SMEM_LIMIT_BYTES


#: The wide launch at the scorecard width: (B, twins per cluster, threads,
#: shared bytes per CTA).  A CTA holds W1 (7 x 512), its 513 x 64 slice
#: of W2, its 65 x 8 rows of W3 (with W3's bias) behind the 64-word
#: product table; per twin the stage input (8), h_1 (512), two h_2 slices
#: (2 x 64), the partials of two stages, the state and the RK4 sum (4 x 8).
WIDE_512 = [(1, 1, 128, 4 * (64 + 3584 + 32832 + 520 + 680)),
            (1024, 4, 512, 4 * (64 + 3584 + 32832 + 520 + 4 * 680))]


@pytest.mark.parametrize("B,twins,threads,smem", WIDE_512)
def test_wide_geometry_at_the_scorecard_width(B, twins, threads, smem):
    geom = tk.launch_geometry(B, (6, 512, 512, 6))
    assert geom == tk.wide_geometry(B, (6, 512, 512, 6))
    assert geom.cluster == tk.WIDE_CLUSTER == 8
    assert geom.twins_per_block == twins
    assert geom.blocks == -(-B // twins) * geom.cluster
    assert geom.threads == threads
    assert geom.smem_bytes == smem == tk.wide_smem_bytes(
        (6, 512, 512, 6), twins) <= tk.SMEM_LIMIT_BYTES


@pytest.mark.parametrize("sizes", [(6, 256, 256, 6), (2, 512, 512, 1),
                                   (6, 640, 640, 6)])
def test_wider_than_a_block_takes_the_cluster_variant(sizes):
    """Lorenz96's 256 width of ``lorenz96_projection``, the HP twin at the
    scorecard width and the widest square twin the variant holds: over
    one block, so check_smem_fit refuses them, and the forward launches
    on clusters while K2 refuses."""
    with pytest.raises(ValueError, match="227 KB"):
        tk.check_smem_fit(sizes)
    for B in (1, 1024):
        geom = tk.launch_geometry(B, sizes)
        assert geom.cluster == tk.WIDE_CLUSTER
        assert geom.smem_bytes <= tk.SMEM_LIMIT_BYTES
    with pytest.raises(ValueError, match="227 KB"):
        tk.launch_geometry(1, sizes, backward=True)


@pytest.mark.parametrize("sizes", [(6, 656, 656, 6), (6, 512, 512, 512, 6),
                                   (60000, 2)])
def test_wide_variant_refuses_above_its_widest_width(sizes):
    with pytest.raises(ValueError, match="cluster variant"):
        tk.launch_geometry(1, sizes)


def test_forced_wide_geometry_at_the_twins_width():
    """The cluster variant also takes widths that fit one block, as the
    card's check of K1w against the resident K1 forces it."""
    geom = tk.wide_geometry(1024, (6, 64, 64, 6), twins_per_block=1)
    assert (geom.cluster, geom.twins_per_block, geom.blocks) == (8, 1, 8192)
    assert geom.threads == 32
    with pytest.raises(ValueError, match="runs on CUDA"):
        tk.fused_node_rollout_at(geom, torch.zeros(2, 6), torch.zeros(3, 0),
                                 [torch.zeros(6, 64), torch.zeros(64, 64),
                                  torch.zeros(64, 6)],
                                 [torch.zeros(64), torch.zeros(64),
                                  torch.zeros(6)], 0.01)


def test_forced_geometry_and_sum_split():
    one = tk.launch_geometry(1024, (6, 64, 64, 6), twins_per_block=1)
    assert (one.twins_per_block, one.blocks) == (1, 1024)
    with pytest.raises(ValueError, match="1 or 4"):
        tk.launch_geometry(16, (6, 64, 64, 6), twins_per_block=2)
    # the summation split depends on the sum's length alone
    assert [tk.ksplit(n) for n in (1, 6, 14, 16, 32, 64, 128, 512)] == [
        1, 1, 1, 2, 4, 8, 8, 8]


def test_mlp_shape_must_map_state():
    y0, u, ws, bs = _l96_inputs()
    with pytest.raises(ValueError, match="does not map"):
        tk.fused_node_rollout(y0[:, :5], u, ws, bs, 0.01, batch_tile=4)


# ---------------------------------------------------------------------------
# No fallback: only CPU tensors take the plain version
# ---------------------------------------------------------------------------

def test_non_cpu_non_cuda_tensors_raise_instead_of_falling_back():
    y0, u, ws, bs = _l96_inputs()
    meta = [x.to("meta") for x in (y0, u)]
    with pytest.raises(ValueError, match="kernel runs on CUDA"):
        tk.fused_node_rollout(*meta, [w.to("meta") for w in ws],
                              [b.to("meta") for b in bs], 0.01, batch_tile=4)
    with pytest.raises(ValueError, match="several devices"):
        tk.fused_node_rollout(y0.to("meta"), u, ws, bs, 0.01, batch_tile=4)


def test_gradient_modes():
    y0, u, ws, bs = _l96_inputs()
    params = [{"w": w.clone().requires_grad_(), "b": b}
              for w, b in zip(ws, bs)]
    vjp = tops.fused_node_rollout(params, y0, u, 0.01, batch_tile=4)
    assert vjp.requires_grad          # "fused_vjp" differentiates via K2
    out = tops.fused_node_rollout(params, y0, u, 0.01, batch_tile=4,
                                  gradient="stopgrad")
    assert not out.requires_grad
    torch.testing.assert_close(vjp.detach(), out, rtol=0, atol=0)
    with torch.no_grad():      # no gradient needed: the forward runs
        same = tops.fused_node_rollout(params, y0, u, 0.01, batch_tile=4)
    torch.testing.assert_close(same, out, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown gradient mode"):
        tops.fused_node_rollout(params, y0, u, 0.01, gradient="adjoint")


# ---------------------------------------------------------------------------
# The kernel build (runs on the card; here only what needs no nvcc)
# ---------------------------------------------------------------------------

def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert _build.sources() == ["counter_noise", "crossbar_vmm",
                                "flash_attention", "fused_analogue",
                                "fused_ode_mlp", "fused_ode_mlp_bwd",
                                "fused_wide", "softdtw", "ssm_scan"]


def test_library_path_follows_the_source(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    src.write_text("// two\n")
    assert _build.library_path("k") != first
    assert first.parent == tmp_path / "build"
