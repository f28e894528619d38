"""Continuous depth on the port against the JAX package, on the CPU.

``core/ode.py`` on bfloat16 states (each Python coefficient of a step
rounded to the state's dtype, as JAX's weak typing does) and its
``linspace_from_zero`` grid, both bit for bit JAX's; float32 steps
bitwise the arithmetic they had before that rounding existed;
``ContinuousDepthBlock`` and the LM ``forward`` with ``ode_depth`` on
the llama3-8b and qwen3-1.7b smokes (JAX-made params carried over with
``interop.lm_params_from_numpy``; the same token arrays into both).

Tolerances, of the peak |ref|: the block 1e-5 in float32 and bitwise in
bfloat16 (an elementwise tanh residual); the forward 1e-4 in float32
(float32 sums in other orders, as the other LM parity tests), and in
bfloat16 ``BF16_FORWARD_TOL`` (1.06e-2 measured) and closer to JAX than
the same forward on ``torch.linspace``'s grid (1.23e-2).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import node as jnode  # noqa: E402
from repro.core import ode as jode  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import node as tnode  # noqa: E402
from repro_torch.core import ode as tode  # noqa: E402
from repro_torch.interop import lm_params_from_numpy  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

METHODS = ["euler", "heun", "midpoint", "rk4", "rk38"]
BF16 = torch.bfloat16
#: bf16 logits of the ode_depth=3 forward vs JAX's, of the peak: the
#: matmuls' bf16 roundings differ between XLA and torch; on torch's own
#: linspace grid (1.328125 for JAX's 1.3359375) the gap is larger.
BF16_FORWARD_TOL = 2e-2


def peak_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def t2n(t):
    return t.detach().to(torch.float32).cpu().numpy()


def port_cfg(jcfg):
    """The port's ArchConfig of a dense JAX smoke config (no MoE, Mamba
    or MLA sub-configs)."""
    return tbase.ArchConfig(**{f.name: getattr(jcfg, f.name)
                               for f in dataclasses.fields(jcfg)})


def state(shape=(64, 256), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# the repaired steps and grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("stop", [2.0, 32.0])
def test_bf16_odeint_bitwise_jax(method, stop):
    """An elementwise field in bfloat16 on a grid of 4 points, where the
    interior points are not exact steps (1.3359375 at stop 2)."""
    x = state()
    ts_j = jnp.linspace(0.0, stop, 4, dtype=jnp.bfloat16)
    ts_t = tode.linspace_from_zero(stop, 4, BF16)
    np.testing.assert_array_equal(as_np(ts_t), as_np(ts_j))
    want = jode.odeint(lambda t, y: jnp.tanh(y), jnp.asarray(x, jnp.bfloat16),
                       ts_j, method=method)
    got = tode.odeint(lambda t, y: torch.tanh(y),
                      torch.from_numpy(x).to(BF16), ts_t, method=method)
    assert got.dtype == BF16
    np.testing.assert_array_equal(as_np(got), as_np(want))


def _old_steps():
    """The port's step arithmetic before the coefficient rounding: Python
    floats straight into ``a * x``."""
    def axpy(a, xs, ys):
        return tree_map(lambda x, y: y + a * x, xs, ys)

    def wsum(coeffs, trees):
        acc = tree_map(lambda x: coeffs[0] * x, trees[0])
        for c, t in zip(coeffs[1:], trees[1:]):
            acc = tree_map(lambda a, x: a + c * x, acc, t)
        return acc

    def euler(f, t, y, dt):
        return axpy(dt, f(t, y), y)

    def heun(f, t, y, dt):
        k1 = f(t, y)
        k2 = f(t + dt, axpy(dt, k1, y))
        return axpy(dt / 2.0, tree_map(lambda a, b: a + b, k1, k2), y)

    def midpoint(f, t, y, dt):
        k1 = f(t, y)
        return axpy(dt, f(t + dt / 2.0, axpy(dt / 2.0, k1, y)), y)

    def rk4(f, t, y, dt):
        k1 = f(t, y)
        k2 = f(t + dt / 2.0, axpy(dt / 2.0, k1, y))
        k3 = f(t + dt / 2.0, axpy(dt / 2.0, k2, y))
        k4 = f(t + dt, axpy(dt, k3, y))
        return axpy(dt, wsum([1 / 6, 1 / 3, 1 / 3, 1 / 6], [k1, k2, k3, k4]),
                    y)

    def rk38(f, t, y, dt):
        k1 = f(t, y)
        k2 = f(t + dt / 3.0, axpy(dt / 3.0, k1, y))
        k3 = f(t + 2 * dt / 3.0, axpy(dt, wsum([-1 / 3, 1.0], [k1, k2]), y))
        k4 = f(t + dt, axpy(dt, wsum([1.0, -1.0, 1.0], [k1, k2, k3]), y))
        return axpy(dt, wsum([1 / 8, 3 / 8, 3 / 8, 1 / 8], [k1, k2, k3, k4]),
                    y)

    return dict(euler=euler, heun=heun, midpoint=midpoint, rk4=rk4, rk38=rk38)


@pytest.mark.parametrize("method", METHODS)
def test_float32_steps_bitwise_unchanged(method):
    """Float32 states (a tensor and a tree) step bitwise as before, with
    a tensor ``dt`` (``odeint``) and a Python-float ``dt``."""
    x = torch.from_numpy(state((16, 32)))
    w = torch.from_numpy(state((32, 32), 1)) / 8

    def f(t, y):
        return torch.tanh(y @ w) - 0.3 * y * t

    old = _old_steps()[method]
    ts = torch.linspace(0.0, 1.5, 7)
    got = tode.odeint(f, x, ts, method=method, steps_per_interval=2)
    y = x
    for i in range(6):
        dt = (ts[i + 1] - ts[i]) / 2
        for j in range(2):
            y = old(f, ts[i] + j * dt, y, dt)
    assert torch.equal(got[-1], y)
    tree = {"a": x, "b": [x * 0.5]}

    def g(t, tr):
        return tree_map(lambda v: f(t, v), tr)

    new_t = tode.STEP_FNS[method](g, 0.25, tree, 0.1)
    old_t = old(g, 0.25, tree, 0.1)
    assert torch.equal(new_t["a"], old_t["a"])
    assert torch.equal(new_t["b"][0], old_t["b"][0])


@pytest.mark.parametrize("method", ["rk4", "rk38"])
def test_bf16_unrounded_coefficients_differ(method):
    """The fault the rounding repairs: with the Python coefficients held in
    float32 (torch's way) the bf16 RK steps leave JAX's bits."""
    x = state()
    ts_j = jnp.linspace(0.0, 2.0, 4, dtype=jnp.bfloat16)
    want = as_np(jode.odeint(lambda t, y: jnp.tanh(y),
                             jnp.asarray(x, jnp.bfloat16), ts_j,
                             method=method)[-1])
    y = torch.from_numpy(x).to(BF16)
    ts = tode.linspace_from_zero(2.0, 4, BF16)
    for i in range(3):
        y = _old_steps()[method](lambda t, v: torch.tanh(v), ts[i], y,
                                 ts[i + 1] - ts[i])
    assert (as_np(y) != want).any()


@pytest.mark.parametrize("depth,steps", [(32, 4), (32, 3), (2, 3), (7, 5)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_grid_bitwise_jnp_linspace(depth, steps, dtype):
    want = jnp.linspace(0.0, float(depth), steps + 1,
                        dtype=getattr(jnp, dtype))
    got = tode.linspace_from_zero(float(depth), steps + 1,
                                  getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(as_np(got), as_np(want))


def test_grid_from_torch_linspace_differs():
    """The fault the grid helper repairs: torch's bf16 linspace lands on
    other points than JAX's."""
    want = as_np(jnp.linspace(0.0, 2.0, 4, dtype=jnp.bfloat16))
    torch_grid = as_np(torch.linspace(0.0, 2.0, 4, dtype=BF16))
    assert want[2] == 1.3359375 and torch_grid[2] == 1.328125
    np.testing.assert_array_equal(
        as_np(tode.linspace_from_zero(2.0, 4, BF16)), want)


# ---------------------------------------------------------------------------
# ContinuousDepthBlock
# ---------------------------------------------------------------------------

def _block_case(dtype):
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((48, 48)) / 7).astype(np.float32)
    b = (0.1 * rng.standard_normal(48)).astype(np.float32)
    h = rng.standard_normal((4, 10, 48)).astype(np.float32)
    jp = {"w": jnp.asarray(w, dtype), "b": jnp.asarray(b, dtype)}
    tdt = torch.float32 if dtype == jnp.float32 else BF16
    tp = {"w": torch.from_numpy(w).to(tdt), "b": torch.from_numpy(b).to(tdt)}
    return jp, tp, jnp.asarray(h, dtype), torch.from_numpy(h).to(tdt)


@pytest.mark.parametrize("method", ["rk4", "heun"])
def test_continuous_depth_block_float32(method):
    jp, tp, jh, th = _block_case(jnp.float32)
    jblk = jnode.ContinuousDepthBlock(
        lambda p, h: jnp.tanh(h @ p["w"] + p["b"]), depth=6.0,
        num_steps=5, method=method)
    tblk = tnode.ContinuousDepthBlock(
        lambda p, h: torch.tanh(h @ p["w"] + p["b"]), depth=6.0,
        num_steps=5, method=method)
    got, want = tblk(tp, th), jblk(jp, jh)
    assert got.shape == th.shape and got.dtype == torch.float32
    assert peak_err(as_np(got), as_np(want)) <= 1e-5


def test_continuous_depth_block_bf16_bitwise():
    """An elementwise residual (tanh(h * w_diag + b)) in bfloat16 over 3
    steps of depth 2, a grid with no exact bf16 steps: bitwise JAX's."""
    jp, tp, jh, th = _block_case(jnp.bfloat16)
    jblk = jnode.ContinuousDepthBlock(
        lambda p, h: jnp.tanh(h * p["w"][0] + p["b"]), depth=2.0,
        num_steps=3)
    tblk = tnode.ContinuousDepthBlock(
        lambda p, h: torch.tanh(h * p["w"][0] + p["b"]), depth=2.0,
        num_steps=3)
    got = tblk(tp, th)
    assert got.dtype == BF16
    np.testing.assert_array_equal(as_np(got), as_np(jblk(jp, jh)))


# ---------------------------------------------------------------------------
# the LM forward with ode_depth
# ---------------------------------------------------------------------------

_PARAMS = {}


def ode_pair(name, **over):
    jcfg = dataclasses.replace(jconfigs.get_smoke(name), **over)
    if jcfg not in _PARAMS:
        jp = jax.jit(jmodel.init_params, static_argnums=0)(
            jcfg, jax.random.PRNGKey(0))
        _PARAMS[jcfg] = (jp, lm_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp), "cpu"))
    return (jcfg, port_cfg(jcfg), *_PARAMS[jcfg])


def tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("name,ode_depth,flash", [
    ("llama3-8b", 2, False), ("llama3-8b", 3, False),
    ("qwen3-1.7b", 2, False), ("qwen3-1.7b", 3, False),
    ("llama3-8b", 3, True)],
    ids=["llama-2", "llama-3", "qwen3-2", "qwen3-3", "llama-3-flash"])
def test_forward_ode_depth_matches_jax(name, ode_depth, flash):
    """The flash case lowers ``flash_threshold`` below S = 64, so every
    RK4 stage's attention takes the flash branch (on the card, one K8
    launch a block evaluation)."""
    over = {"ode_depth": ode_depth}
    if flash:
        over["flash_threshold"] = 32
    jcfg, tcfg, jp, tp = ode_pair(name, **over)
    s = 64 if flash else 16
    toks = tokens(21, (2, s), jcfg.vocab)
    jl, ja, _ = jmodel.forward(jp, jcfg, jnp.asarray(toks))
    tl, ta, cache = tmodel.forward(tp, tcfg, torch.from_numpy(toks).long(),
                                   return_cache=True)
    assert tl.dtype == torch.float32 and tl.shape == (2, s, jcfg.vocab)
    assert peak_err(t2n(tl), jl) <= 1e-4
    assert float(ta) == float(ja) == 0.0
    assert cache["stack"] is None and cache["prelude"] == []


def test_forward_ode_depth_bf16_matches_jax():
    """bf16 at ode_depth = 3 over the smoke's 2 periods: the grid's
    interior points (0.6679688, 1.3359375) are not exact bf16 steps.  The
    repaired port is within ``BF16_FORWARD_TOL`` of JAX; the same forward
    on ``torch.linspace``'s grid is not."""
    jcfg, tcfg, jp, tp = ode_pair("llama3-8b", ode_depth=3,
                                  dtype="bfloat16")
    toks = tokens(22, (2, 16), jcfg.vocab)
    jl, _, _ = jmodel.forward(jp, jcfg, jnp.asarray(toks))
    tl, _, _ = tmodel.forward(tp, tcfg, torch.from_numpy(toks).long())
    err = peak_err(t2n(tl), jl)
    assert err <= BF16_FORWARD_TOL, err
    grid = tode.linspace_from_zero
    try:
        tnode.linspace_from_zero = lambda stop, n, dtype, device=None: \
            torch.linspace(0.0, stop, n, dtype=dtype, device=device)
        tl_old, _, _ = tmodel.forward(tp, tcfg, torch.from_numpy(toks).long())
    finally:
        tnode.linspace_from_zero = grid
    assert peak_err(t2n(tl_old), jl) > err


def test_ode_tree_has_one_period_and_fewer_leaves():
    jcfg, tcfg, _, _ = ode_pair("llama3-8b", ode_depth=2)
    ode_params = tmodel.init_params(tcfg, seed=0, device="cpu")
    shapes = jax.eval_shape(lambda k: jmodel.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    jl = jax.tree_util.tree_leaves(shapes)
    tl = jax.tree_util.tree_leaves(ode_params)
    assert [tuple(x.shape) for x in tl] == [tuple(x.shape) for x in jl]
    assert all(x.shape[0] == 1 for x in jax.tree_util.tree_leaves(
        ode_params["stack"]))
    full = tmodel.init_params(dataclasses.replace(tcfg, ode_depth=0),
                              seed=0, device="cpu")
    n_ode = sum(x.numel() for x in tl)
    n_full = sum(x.numel() for x in jax.tree_util.tree_leaves(full))
    assert n_ode < n_full
