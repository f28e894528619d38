"""The port's fused VJP (K2's plain version and the autograd path through
``repro_torch.kernels.fused_ode_mlp_bwd``) against JAX.

On the CPU the K2 wrapper runs its plain version; these tests hold it,
and autograd through ``FusedNodeRollout``, against the JAX package's
fused VJP (its Pallas kernels in interpret mode, with the time chunks of
``tests/test_gradients.py``) and against autograd through the port's
``fused_node_rollout_ref``, on the same numpy-made inputs, to 1e-5 of
each gradient's peak.  The CUDA kernel itself is held against the same
plain version on the card by ``chip_smoke.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import twin as jtwin  # noqa: E402
from repro.core.backends import FusedPallasBackend  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.fused_ode_mlp import DEFAULT_VMEM_BUDGET  # noqa: E402
from repro.kernels.fused_ode_mlp_bwd import (  # noqa: E402
    fused_node_rollout_vjp as j_vjp)
from repro_torch.core import twin as ttwin  # noqa: E402
from repro_torch.core.backends import FusedCudaBackend  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import fused_ode_mlp_bwd as tk2  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = 1e-5      # of each gradient's peak; measured ~1e-7 (f32 sum order)


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def make_inputs(seed, sizes, B, T, drive):
    """He-init weights with random biases, y0, the drive at half-steps
    and a cotangent for every trajectory row, all numpy float32."""
    rng = np.random.default_rng(seed)
    ws = [(rng.standard_normal((a, b)) * np.sqrt(2.0 / a)).astype(np.float32)
          for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [(0.1 * rng.standard_normal(b)).astype(np.float32)
          for b in sizes[1:]]
    D = sizes[-1]
    y0 = (0.3 * rng.standard_normal((B, D))).astype(np.float32)
    ts = np.linspace(0.0, 0.5, T + 1, dtype=np.float32)
    th = np.linspace(0.0, 0.5, 2 * T + 1)
    if drive == "none":
        uh = np.zeros((2 * T + 1, 0), np.float32)
    elif drive == "shared":
        uh = np.sin(4 * th)[:, None].astype(np.float32)
    else:
        amps = 0.5 + np.arange(B) / B
        uh = (amps[:, None] * np.sin(4 * th)[None])[..., None]
        uh = uh.astype(np.float32)
    gw = rng.standard_normal((T + 1, B, D)).astype(np.float32)
    return ws, bs, y0, uh, gw, float(ts[1] - ts[0])


def jax_grads(ws, bs, y0, uh, gw, dt, bt, chunk):
    """(dy0, dws, dbs) of sum(traj * gw) through the JAX fused VJP."""
    g = jax.grad(lambda y, w, b: jnp.sum(
        j_vjp(y, jnp.asarray(uh), w, b, dt, bt, chunk, None,
              DEFAULT_VMEM_BUDGET, "f32") * jnp.asarray(gw)),
        argnums=(0, 1, 2))(jnp.asarray(y0), [jnp.asarray(w) for w in ws],
                           [jnp.asarray(b) for b in bs])
    return [np.asarray(g[0])] + [np.asarray(x) for x in g[1] + g[2]]


def torch_grads(forward, ws, bs, y0, uh, gw):
    """(dy0, dws, dbs) of sum(forward(y0, uh, ws, bs) * gw) by autograd."""
    y = t(y0).requires_grad_()
    w = [t(x).requires_grad_() for x in ws]
    b = [t(x).requires_grad_() for x in bs]
    (forward(y, t(uh), w, b) * t(gw)).sum().backward()
    return [y.grad.numpy()] + [x.grad.numpy() for x in w + b]


def assert_grads_close(got, want, tol=TOL):
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        err = np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30)
        assert err <= tol, (i, err)


# mirrors tests/test_gradients.py::test_fused_vjp_matches_ref_autodiff
VJP_CASES = {
    "hp_shared_drive_chunk3": ((2, 14, 14, 1), "shared", 11, 3, 4),
    "autonomous_partial_tail_chunk": ((6, 32, 32, 6), "none", 21, 4, 8),
    "single_chunk_over_T": ((3, 8, 2), "shared", 5, 8, 8),
    "per_twin_drives": ((2, 14, 14, 1), "per_twin", 11, 3, 4),
}


@pytest.mark.parametrize("case", sorted(VJP_CASES))
def test_plain_k2_matches_jax_fused_vjp_and_autodiff(case):
    sizes, drive, T, chunk, bt = VJP_CASES[case]
    ws, bs, y0, uh, gw, dt = make_inputs(7, sizes, 8, T, drive)
    want = jax_grads(ws, bs, y0, uh, gw, dt, bt, chunk)
    autodiff = torch_grads(
        lambda y, u, w, b: tref.fused_node_rollout_ref(y, u, w, b, dt),
        ws, bs, y0, uh, gw)
    # K2's plain version on the forward trajectory
    traj = tref.fused_node_rollout_ref(t(y0), t(uh), [t(w) for w in ws],
                                       [t(b) for b in bs], dt)
    dy0, dws, dbs = tk2.fused_node_rollout_bwd(
        traj, t(uh), [t(w) for w in ws], [t(b) for b in bs], t(gw), dt)
    plain = [dy0.numpy()] + [x.numpy() for x in dws + dbs]
    assert all(x.dtype == np.float32 for x in plain)
    # the autograd Function (K1 forward, K2 backward)
    fused = torch_grads(
        lambda y, u, w, b: tk2.fused_node_rollout_vjp(y, u, w, b, dt,
                                                      batch_tile=bt),
        ws, bs, y0, uh, gw)
    for got in (plain, fused):
        assert_grads_close(got, want)
        assert_grads_close(got, autodiff)


def test_drive_gets_zero_cotangent():
    ws, bs, y0, uh, _, dt = make_inputs(3, (2, 8, 1), 4, 6, "shared")
    u = t(uh).requires_grad_()
    out = tk2.fused_node_rollout_vjp(t(y0), u, [t(w) for w in ws],
                                     [t(b) for b in bs], dt, batch_tile=4)
    (out ** 2).sum().backward()
    assert u.grad.shape == u.shape
    assert float(u.grad.abs().max()) == 0.0
    jg = jax.grad(lambda v: jnp.sum(j_vjp(
        jnp.asarray(y0), v, [jnp.asarray(w) for w in ws],
        [jnp.asarray(b) for b in bs], dt, 4, None, None) ** 2))(
            jnp.asarray(uh))
    np.testing.assert_array_equal(u.grad.numpy(), np.asarray(jg))


def test_noncontiguous_cotangent_and_dtypes():
    """A trainer slices and transposes the trajectory before its loss, so
    the cotangent arrives strided; float64 primals get float64 grads."""
    ws, bs, y0, uh, gw, dt = make_inputs(4, (2, 14, 14, 1), 6, 9, "per_twin")
    w = [t(x).double().requires_grad_() for x in ws]
    b = [t(x).double().requires_grad_() for x in bs]
    y = t(y0).double().requires_grad_()
    traj = tk2.fused_node_rollout_vjp(y, t(uh), w, b, dt, batch_tile=6)
    preds = traj[::3, :4].transpose(0, 1)        # (4, 4, 1), strided
    (preds * t(gw[::3, :4]).transpose(0, 1)).sum().backward()
    assert y.grad.dtype == w[0].grad.dtype == b[0].grad.dtype == torch.float64
    gfull = np.zeros_like(gw)
    gfull[::3, :4] = gw[::3, :4]
    want = torch_grads(
        lambda y_, u_, w_, b_: tref.fused_node_rollout_ref(y_, u_, w_, b_, dt),
        ws, bs, y0, uh, gfull)
    assert_grads_close([y.grad.numpy()] + [x.grad.numpy() for x in w + b],
                       want)
    assert float(np.abs(y.grad.numpy()[4:]).max()) == 0.0


# ---------------------------------------------------------------------------
# The twin level: FusedCudaBackend differentiates through K2
# ---------------------------------------------------------------------------

def _hp_twins(batch_tile):
    rng = np.random.default_rng(11)
    sizes = (2, 14, 14, 1)
    p = [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / a))
          .astype(np.float32),
          "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
         for a, b in zip(sizes[:-1], sizes[1:])]
    jt = jtwin.make_driven_twin(1, lambda s: jnp.sin(4.0 * s))
    tt = ttwin.make_driven_twin(1, lambda s: torch.sin(4.0 * s))
    ts = np.linspace(0.0, 0.23, 24).astype(np.float32)
    y0s = (0.3 * rng.standard_normal((5, 1))).astype(np.float32)
    jf = jt.with_backend(FusedPallasBackend(batch_tile=batch_tile,
                                            precision="f32"))
    tf = tt.with_backend(FusedCudaBackend(batch_tile=batch_tile))
    return p, jt, tt, jf, tf, ts, y0s


def _torch_param_grads(loss, p):
    tp = params_from_numpy(p, "cpu")
    for layer in tp:
        for v in layer.values():
            v.requires_grad_()
    loss(tp).backward()
    return [v.grad.numpy() for layer in tp for v in layer.values()]


def _jax_param_grads(loss, p):
    g = jax.grad(loss)([{k: jnp.asarray(v) for k, v in layer.items()}
                        for layer in p])
    return [np.asarray(layer[k]) for layer in g for k in ("w", "b")]


def test_fleet_padding_rows_contribute_nothing():
    """B=5 with batch_tile=4 pads the fleet to 8 twins (mirrors
    tests/test_gradients.py::test_fused_fleet_batch_gradients): the
    padded rows must add nothing, so the fused gradient equals JAX's
    fused gradient and agrees with the digital adjoint's."""
    p, jt, tt, jf, tf, ts, y0s = _hp_twins(batch_tile=4)
    got = _torch_param_grads(
        lambda q: torch.mean(tf.simulate_batch(q, t(y0s), t(ts)) ** 2), p)
    want = _jax_param_grads(
        lambda q: jnp.mean(jf.simulate_batch(q, jnp.asarray(y0s),
                                             jnp.asarray(ts)) ** 2), p)
    assert_grads_close(got, want)
    digital = _torch_param_grads(
        lambda q: torch.mean(tt.simulate_batch(q, t(y0s), t(ts)) ** 2), p)
    assert_grads_close(got, digital, tol=1e-3)


def test_stopgrad_detaches():
    """gradient='stopgrad' pins the substrate to inference: the solve
    carries no graph, so the params get no gradient from it."""
    p, _, tt, _, tf, ts, y0s = _hp_twins(batch_tile=1)
    node = dataclasses.replace(tf.node, gradient="stopgrad")
    tp = params_from_numpy(p, "cpu")
    leaves = [v.requires_grad_() for layer in tp for v in layer.values()]
    out = node.trajectory(tp, t(y0s[0]), t(ts))
    assert not out.requires_grad
    with_grad = tf.node.trajectory(tp, t(y0s[0]), t(ts))
    assert with_grad.requires_grad
    np.testing.assert_array_equal(out.numpy(), with_grad.detach().numpy())
    grads = torch.autograd.grad(with_grad.sum(), leaves)
    assert all(float(g.abs().max()) > 0 for g in grads[::2])


def test_ops_gradient_modes_match_jax_ops():
    ws, bs, y0, uh, gw, dt = make_inputs(5, (2, 14, 14, 1), 8, 30, "shared")
    p = [{"w": w, "b": b} for w, b in zip(ws, bs)]
    got = _torch_param_grads(lambda q: (tops.fused_node_rollout(
        q, t(y0), t(uh), dt, batch_tile=8) * t(gw)).sum(), p)
    want = _jax_param_grads(lambda q: jnp.sum(jops.fused_node_rollout(
        q, jnp.asarray(y0), jnp.asarray(uh), dt, batch_tile=8,
        gradient="fused_vjp", precision="f32") * jnp.asarray(gw)), p)
    assert_grads_close(got, want)


# ---------------------------------------------------------------------------
# Shapes, shared memory and placement
# ---------------------------------------------------------------------------

def test_smem_bytes_bwd_fits_training_widths_and_refuses_wider():
    hp = tk2.smem_bytes_bwd((2, 14, 14, 1))
    l96 = tk2.smem_bytes_bwd((6, 64, 64, 6))
    wide = tk2.smem_bytes_bwd((6, 128, 128, 6))
    assert hp < l96 < wide <= tk2._k1.SMEM_LIMIT_BYTES
    # the fleet's four-twin block needs the raised dynamic allowance
    assert tk2.smem_bytes_bwd((6, 64, 64, 6), twins_per_block=4) > 48 * 1024
    with pytest.raises(ValueError, match="227 KB"):
        tk2.smem_bytes_bwd((6, 512, 512, 6))


@pytest.mark.parametrize("B", [9, 14, 29, 8, 1024])
def test_bwd_geometry_matches_forward_tiling(B):
    """K2 tiles the fleet as K1 does, so its blocks cover the same twins,
    and its threads hold every 4 x 4 gradient tile."""
    sizes = (2, 14, 14, 1) if B == 9 else (6, 64, 64, 6)
    fwd = tk2._k1.launch_geometry(B, sizes)
    bwd = tk2._k1.launch_geometry(B, sizes, backward=True)
    assert (bwd.twins_per_block, bwd.blocks) == (fwd.twins_per_block,
                                                 fwd.blocks)
    assert bwd.smem_bytes == tk2._k1.smem_bytes_k2(
        sizes, bwd.twins_per_block, bwd.time_chunk)
    assert (tk2._k1.gradient_tiles(sizes)
            <= tk2._k1.MAX_TILES_PER_THREAD * bwd.threads)


def test_gradient_tiles_cover_the_parameters():
    for sizes in [(2, 14, 14, 1), (6, 64, 64, 6), (3, 2), (6, 128, 128, 6)]:
        P = sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))
        assert 16 * tk2._k1.gradient_tiles(sizes) >= P


def test_bwd_rejects_bad_shapes_and_devices():
    ws, bs, y0, uh, gw, dt = make_inputs(6, (2, 8, 1), 4, 6, "shared")
    traj = tref.fused_node_rollout_ref(t(y0), t(uh), [t(w) for w in ws],
                                       [t(b) for b in bs], dt)
    args = [[t(w) for w in ws], [t(b) for b in bs]]
    with pytest.raises(ValueError, match="must both be"):
        tk2.fused_node_rollout_bwd(traj, t(uh), *args, t(gw[1:]), dt)
    with pytest.raises(ValueError, match="half-steps"):
        tk2.fused_node_rollout_bwd(traj, t(uh[:-2]), *args, t(gw), dt)
    with pytest.raises(ValueError, match="does not map"):
        tk2.fused_node_rollout_bwd(traj, t(np.zeros((13, 0), np.float32)),
                                   *args, t(gw), dt)
    with pytest.raises(ValueError, match="non-floating"):
        tk2.fused_node_rollout_bwd(traj, t(uh), *args,
                                   t(gw).to(torch.int32), dt)
    meta = [x.to("meta") for x in (traj, t(uh), t(gw))]
    with pytest.raises(ValueError, match="kernel runs on CUDA"):
        tk2.fused_node_rollout_bwd(
            meta[0], meta[1], [w.to("meta") for w in args[0]],
            [b.to("meta") for b in args[1]], meta[2], dt)
    with pytest.raises(ValueError, match="several devices"):
        tk2.fused_node_rollout_bwd(traj.to("meta"), t(uh), *args, t(gw), dt)


def test_split_grads_layout():
    sizes = (3, 4, 2)
    flat = torch.arange(3 * 4 + 4 + 4 * 2 + 2, dtype=torch.float32)
    dws, dbs = tk2._split_grads(flat, sizes)
    assert [tuple(w.shape) for w in dws] == [(3, 4), (4, 2)]
    assert [tuple(b.shape) for b in dbs] == [(4,), (2,)]
    assert float(dbs[0][0]) == 12.0 and float(dws[1][0, 0]) == 16.0
