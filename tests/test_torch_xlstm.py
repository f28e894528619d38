"""The port's xLSTM mixers and the xlstm-125m smoke against the JAX
package, on the CPU.

Each function of ``models/xlstm.py`` on params made by JAX's
initialisers and carried over with ``interop.lm_params_from_numpy``,
inputs made with numpy from a seed, the mLSTM prefill over 3 chunks;
the sLSTM step and both decodes from the same (JAX-made) state; the
whole smoke model's forward and 4 decode steps; the init trees.

Tolerances, of the peak |ref|: the functions 1e-5 (float32 sums and
exponentials in other orders), the model 1e-4 (the LM parity tests'
limit).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.interop import lm_params_from_numpy  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402

FN_TOL = 1e-5
MODEL_TOL = 1e-4
#: d_model 32, 2 heads (mLSTM head_dim 32, sLSTM 16), chunk 8.
JCFG = jx.XLSTMConfig(d_model=32, n_heads=2, chunk=8)
TCFG = tx.XLSTMConfig(d_model=32, n_heads=2, chunk=8)
SEQ = 3 * JCFG.chunk


def peak_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def t2n(t):
    return t.detach().to(torch.float32).cpu().numpy()


def carry(tree):
    return lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                "cpu")


def x_of(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def assert_close(got, want, tol=FN_TOL):
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert tuple(g.shape) == tuple(w.shape)
        assert peak_err(t2n(g), w) <= tol


@pytest.fixture(scope="module")
def mlstm():
    jp = jx.mlstm_init(jax.random.PRNGKey(0), JCFG)
    return jp, carry(jp)


@pytest.fixture(scope="module")
def slstm():
    jp = jx.slstm_init(jax.random.PRNGKey(1), JCFG)
    return jp, carry(jp)


def test_config_widths_match_jax():
    for f in ("d_inner", "head_dim"):
        assert getattr(TCFG, f) == getattr(JCFG, f)
    smoke = tconfigs.get_smoke("xlstm-125m")
    assert dataclasses.asdict(smoke.xlstm_cfg()) == dataclasses.asdict(
        jconfigs.get_smoke("xlstm-125m").xlstm_cfg())


def test_conv_silu_and_heads_match_jax(mlstm):
    jp, tp = mlstm
    x = x_of(0, (2, SEQ, JCFG.d_inner))
    assert_close(tx._conv_silu(tp, TCFG, torch.from_numpy(x)),
                 jx._conv_silu(jp, JCFG, jnp.asarray(x)))
    np.testing.assert_array_equal(
        t2n(tx._heads(torch.from_numpy(x), 2)),
        np.asarray(jx._heads(jnp.asarray(x), 2)))


@pytest.mark.parametrize("first", [True, False], ids=["zero", "carried"])
def test_mlstm_chunk_matches_jax(first):
    """One chunk from the zero state (m = -1e30) and from a carried one."""
    b, h, L, dk = 2, 2, 8, 16
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((b, h, L, dk)).astype(np.float32)
               for _ in range(3))
    lgi = rng.standard_normal((b, h, L)).astype(np.float32)
    lgf = np.log(1 / (1 + np.exp(-rng.standard_normal((b, h, L))))).astype(
        np.float32)
    if first:
        st = (np.zeros((b, h, dk, dk), np.float32),
              np.zeros((b, h, dk), np.float32),
              np.full((b, h), -1e30, np.float32))
    else:
        st = (rng.standard_normal((b, h, dk, dk)).astype(np.float32),
              rng.standard_normal((b, h, dk)).astype(np.float32),
              rng.standard_normal((b, h)).astype(np.float32))
    want = jx._mlstm_chunk(*map(jnp.asarray, (q, k, v, lgi, lgf)),
                           tuple(map(jnp.asarray, st)))
    got = tx._mlstm_chunk(*map(torch.from_numpy, (q, k, v, lgi, lgf)),
                          tuple(map(torch.from_numpy, st)))
    assert_close(got, want)


def test_mlstm_prefill_three_chunks_and_decode_match_jax(mlstm):
    jp, tp = mlstm
    x = x_of(3, (2, SEQ, JCFG.d_model))
    jy, jst = jx.mlstm_prefill(jp, JCFG, jnp.asarray(x))
    ty, tst = tx.mlstm_prefill(tp, TCFG, torch.from_numpy(x))
    assert_close(ty, jy)
    assert_close(tst, jst)
    # decode from JAX's state, the same token into both
    x1 = x_of(4, (2, 1, JCFG.d_model))
    jy1, jst1 = jx.mlstm_decode(jp, JCFG, jnp.asarray(x1), jst)
    ty1, tst1 = tx.mlstm_decode(tp, TCFG, torch.from_numpy(x1),
                                tuple(torch.from_numpy(np.array(a))
                                      for a in jst))
    assert_close(ty1, jy1)
    assert_close(tst1, jst1)


def test_mlstm_prefill_refuses_a_ragged_chunk(mlstm):
    _, tp = mlstm
    with pytest.raises(ValueError, match="% chunk 8 != 0"):
        tx.mlstm_prefill(tp, TCFG, torch.zeros((1, 20, JCFG.d_model)))
    # a sequence shorter than the chunk is one chunk of its own length
    y, _ = tx.mlstm_prefill(tp, TCFG, torch.zeros((1, 5, JCFG.d_model)))
    assert y.shape == (1, 5, JCFG.d_model)


def test_slstm_step_prefill_and_decode_match_jax(slstm):
    jp, tp = slstm
    for got, want in zip(tx.slstm_zero_state(TCFG, 2),
                         jx.slstm_zero_state(JCFG, 2)):
        np.testing.assert_array_equal(t2n(got), np.asarray(want))
    x = x_of(5, (2, SEQ, JCFG.d_model))
    jy, jc = jx.slstm_prefill(jp, JCFG, jnp.asarray(x))
    ty, tc = tx.slstm_prefill(tp, TCFG, torch.from_numpy(x))
    assert_close(ty, jy)
    assert_close(tc, jc)
    state = tuple(torch.from_numpy(np.array(a)) for a in jc)
    wx = x_of(6, (2, 4 * JCFG.d_model))
    assert_close(tx._slstm_step(tp, TCFG, state, torch.from_numpy(wx)),
                 jx._slstm_step(jp, JCFG, jc, jnp.asarray(wx)))
    x1 = x_of(7, (2, 1, JCFG.d_model))
    jy1, jc1 = jx.slstm_decode(jp, JCFG, jnp.asarray(x1), jc)
    ty1, tc1 = tx.slstm_decode(tp, TCFG, torch.from_numpy(x1), state)
    assert_close(ty1, jy1)
    assert_close(tc1, jc1)


def test_bf16_dtypes_follow_jax():
    """In a bf16 model ``wi``, ``wf`` and the sLSTM bias stay float32, q,
    k and v are float32 after their bf16 products, the states are float32
    and the outputs bf16."""
    gen = torch.Generator().manual_seed(0)
    mp = tx.mlstm_init(gen, TCFG, torch.bfloat16)
    sp = tx.slstm_init(gen, TCFG, torch.bfloat16)
    assert mp["up"].dtype == torch.bfloat16
    assert mp["wi"].dtype == mp["wf"].dtype == sp["b"].dtype == torch.float32
    x = torch.randn((1, 16, 32), generator=gen).to(torch.bfloat16)
    y, (c, n, m) = tx.mlstm_prefill(mp, TCFG, x)
    assert y.dtype == torch.bfloat16
    assert c.dtype == n.dtype == m.dtype == torch.float32
    y, st = tx.slstm_prefill(sp, TCFG, x)
    assert y.dtype == torch.bfloat16
    assert all(s.dtype == torch.float32 for s in st)


# ---------------------------------------------------------------------------
# the xlstm-125m smoke model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_pair():
    jcfg = jconfigs.get_smoke("xlstm-125m")
    tcfg = tconfigs.get_smoke("xlstm-125m")
    jp = jax.jit(jmodel.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, carry(jp)


def test_smoke_forward_and_four_decode_steps_match_jax(smoke_pair):
    jcfg, tcfg, jp, tp = smoke_pair
    toks = np.random.default_rng(8).integers(0, jcfg.vocab, (2, 16),
                                             dtype=np.int32)
    jl, _, _ = jmodel.forward(jp, jcfg, jnp.asarray(toks))
    tl, ta, _ = tmodel.forward(tp, tcfg, torch.from_numpy(toks).long())
    assert tl.shape == (2, 16, jcfg.vocab) and tl.dtype == torch.float32
    assert peak_err(t2n(tl), jl) <= MODEL_TOL
    assert float(ta) == 0.0
    jcache = jmodel.init_cache(jcfg, 2, 16)
    tcache = tmodel.init_cache(tcfg, 2, 16, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(jcache),
                    jax.tree_util.tree_leaves(tcache)):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(t2n(b), np.asarray(a))
    for i in range(4):
        jl, jcache = jmodel.decode_step(jp, jcfg, jnp.asarray(toks[:, i:i + 1]),
                                        jnp.asarray(i, jnp.int32), jcache)
        tl, tcache = tmodel.decode_step(
            tp, tcfg, torch.from_numpy(toks[:, i:i + 1]).long(), i, tcache)
        assert peak_err(t2n(tl), jl) <= MODEL_TOL


def test_init_trees_match_jax():
    """The tree, shapes and dtypes of JAX's, at the smoke's float32 and in
    bf16 (f32 leaves kept f32); the analytic ``param_count`` is JAX's."""
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(jconfigs.get_smoke("xlstm-125m"),
                                   dtype=dtype)
        tcfg = dataclasses.replace(tconfigs.get_smoke("xlstm-125m"),
                                   dtype=dtype)
        shapes = jax.eval_shape(lambda k: jmodel.init_params(jcfg, k),
                                jax.random.PRNGKey(0))
        params = tmodel.init_params(tcfg, seed=0, device="cpu")
        jl, _ = jax.tree_util.tree_flatten_with_path(shapes)
        tl, _ = jax.tree_util.tree_flatten_with_path(params)
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (_, j), (_, t) in zip(jl, tl):
            assert tuple(t.shape) == tuple(j.shape)
            assert str(t.dtype).replace("torch.", "") == str(j.dtype)
        assert tbase.param_count(tcfg) == jbase.param_count(jcfg)
        assert sum(t.numel() for _, t in tl) == sum(j.size for _, j in jl)
        mix = params["stack"]["b0"]["mixer"]
        assert mix["wi"].dtype == mix["wf"].dtype == torch.float32
        assert params["stack"]["b5"]["mixer"]["b"].dtype == torch.float32
