"""The port's digital baselines (``repro_torch.models.baselines``, their
trainers and recipes) against the JAX package, on the CPU.

Parameters are made by the JAX package's initialisers and carried over
as numpy (``interop``), inputs are numpy-made from a seed.  Tolerances:
cells, rollouts and forecasts 1e-5 of the peak; 5-step loss histories
1e-4 relative per step (inputs noise-free: the port draws noise from
torch generators, JAX from its keys).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import baselines as jb  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.interop import (lm_params_from_numpy,  # noqa: E402
                                 lm_params_to_numpy, params_from_numpy)
from repro_torch.models import baselines as tb  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import recipes as trecipes  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

TOL = 1e-5
HIST_TOL = 1e-4
CELLS = ("lstm", "gru", "rnn")


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def series(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def forecaster(cell, hidden=16):
    jm = jb.RecurrentForecaster(cell=cell, in_dim=6, hidden=hidden, out_dim=6)
    tm = tb.RecurrentForecaster(cell=cell, in_dim=6, hidden=hidden, out_dim=6)
    jp = jm.init(jax.random.PRNGKey(CELLS.index(cell)))
    return jm, tm, jp, lm_params_from_numpy(to_numpy(jp), "cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_cells_and_forecasts_match_jax(cell):
    jm, tm, jp, tp = forecaster(cell)
    # the tree carries both ways unchanged
    back = lm_params_to_numpy(tp)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(to_numpy(jp))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(to_numpy(jp))):
        np.testing.assert_array_equal(a, b)
    # one cell step from a non-zero carry
    _, jstep, _ = jb.CELLS[cell]
    _, tstep, tcarry = tb.CELLS[cell]
    x, h = series(1, (6,)), series(2, (16,), 0.5)
    jcarry = (jnp.asarray(h), jnp.asarray(0.3 * h)) if cell == "lstm" \
        else jnp.asarray(h)
    tc = (t(h), t(0.3 * h)) if cell == "lstm" else t(h)
    jc, jy = jstep(jp["cell"], jcarry, jnp.asarray(x))
    tc, ty = tstep(tp["cell"], tc, t(x))
    assert rel(ty.numpy(), jy) <= TOL
    for a, b in zip(jax.tree_util.tree_leaves(tc),
                    jax.tree_util.tree_leaves(jc)):
        assert rel(a.numpy(), b) <= TOL
    zero = tcarry(16, torch.zeros(3, 6))
    assert all(tuple(z.shape) == (3, 16) and not z.any()
               for z in jax.tree_util.tree_leaves(zero))
    # teacher forcing and the closed loop with its warm-up
    ys = series(3, (40, 6))
    want = np.asarray(jm.teacher_forced(jp, jnp.asarray(ys)))
    got = tm.teacher_forced(tp, t(ys))
    assert tuple(got.shape) == want.shape == (39, 6)
    assert rel(got.numpy(), want) <= TOL
    want = np.asarray(jm.closed_loop(jp, jnp.asarray(ys[0]), 30,
                                     warmup=jnp.asarray(ys[:12])))
    got = tm.closed_loop(tp, t(ys[0]), 30, warmup=t(ys[:12]))
    assert tuple(got.shape) == want.shape == (31, 6)
    assert rel(got.numpy(), want) <= TOL
    cold = tm.closed_loop(tp, t(ys[0]), 30)
    assert rel(cold.numpy(), np.asarray(jm.closed_loop(
        jp, jnp.asarray(ys[0]), 30))) <= TOL
    # leading batch axes: a batch of series is its series one by one
    batch = t(np.stack([ys, ys[::-1]]))
    both = tm.teacher_forced(tp, batch)
    assert rel(both[1].numpy(), tm.teacher_forced(
        tp, batch[1]).numpy()) <= 1e-6


def resnet_case():
    jm = jb.RecurrentResNet(sizes=(2, 14, 14, 1), state_dim=1)
    tm = tb.RecurrentResNet(sizes=(2, 14, 14, 1), state_dim=1)
    jp = jm.init(jax.random.PRNGKey(42))
    return jm, tm, jp, params_from_numpy(to_numpy(jp), "cpu")


def test_resnet_rollout_matches_jax_and_batches():
    jm, tm, jp, tp = resnet_case()
    # a non-zero last layer, so the residual does something
    p = to_numpy(jp)
    p[-1]["w"] = series(4, p[-1]["w"].shape, 0.3)
    jp = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in p]
    tp = params_from_numpy(p, "cpu")
    us, y0 = series(5, (60, 1)), np.array([0.1], np.float32)
    want = np.asarray(jm.rollout(jp, jnp.asarray(y0), jnp.asarray(us)))
    got = tm.rollout(tp, t(y0), t(us))
    assert tuple(got.shape) == want.shape == (61, 1)
    assert rel(got.numpy(), want) <= TOL
    y0s = np.array([[0.1], [0.4], [-0.2]], np.float32)
    uss = series(6, (3, 60, 1))
    batch = tm.rollout(tp, t(y0s), t(uss))
    assert tuple(batch.shape) == (3, 61, 1)
    for i in range(3):
        want = np.asarray(jm.rollout(jp, jnp.asarray(y0s[i]),
                                     jnp.asarray(uss[i])))
        assert rel(batch[i].numpy(), want) <= TOL


def test_resnet_init_zeroes_the_last_layer():
    """The near-identity init: the last layer's weights are zero and its
    bias kept (the JAX package's fix for seed 42's divergence); the other
    layers are He-init."""
    _, tm, _, _ = resnet_case()
    p = tm.init(torch.Generator().manual_seed(42), device="cpu")
    assert [tuple(x["w"].shape) for x in p] == [(2, 14), (14, 14), (14, 1)]
    assert not p[-1]["w"].any() and not p[-1]["b"].any()
    assert all(x["w"].abs().min() > 0 for x in p[:-1])
    us = t(series(7, (20, 1)))
    flat = tm.rollout(p, torch.tensor([0.25]), us)
    assert torch.equal(flat, torch.full((21, 1), 0.25))


def hist_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def test_train_recurrent_resnet_history_matches_jax():
    jm, tm, jp, tp = resnet_case()
    us, ys = series(8, (101, 1)), series(9, (101, 1), 0.1)
    _, want = jtrainer.train_recurrent_resnet(
        jm, jp, jnp.asarray(us), jnp.asarray(ys),
        optimizer=jopt.adam(1e-2), num_steps=5, segment_len=25)
    params, got = ttrainer.train_recurrent_resnet(
        tm, tp, t(us), t(ys), optimizer=topt.adam(1e-2), num_steps=5,
        segment_len=25)
    assert tuple(got.shape) == (5,)
    assert hist_rel(got, want) <= HIST_TOL
    assert float(params[-1]["w"].abs().max()) > 0       # it trained


@pytest.mark.parametrize("cell", CELLS)
def test_train_forecaster_history_matches_jax(cell):
    jm, tm, jp, tp = forecaster(cell)
    ys = series(10, (60, 6))
    _, want = jtrainer.train_forecaster(jm, jp, jnp.asarray(ys),
                                        optimizer=jopt.adam(1e-2),
                                        num_steps=5)
    _, got = ttrainer.train_forecaster(tm, tp, t(ys),
                                       optimizer=topt.adam(1e-2),
                                       num_steps=5)
    assert hist_rel(got, want) <= HIST_TOL
    # input noise: drawn per step from the generator, the eager loop's bits
    kw = dict(optimizer=topt.adam(1e-2), num_steps=4, noise_std=0.05)
    _, noisy = ttrainer.train_forecaster(
        tm, tp, t(ys), generator=torch.Generator().manual_seed(1), **kw)
    _, again = ttrainer.train_forecaster(
        tm, tp, t(ys), generator=torch.Generator().manual_seed(1), **kw)
    assert torch.equal(noisy, again) and not torch.equal(noisy, got[:4])


def test_recipes_run_on_the_cpu():
    """The Fig. 3j and Fig. 4g recipes end to end at tiny budgets (the
    Fig. 3j gate runs at the JAX test's budget in test_torch_training.py;
    ``chip_smoke.py`` runs both on the card)."""
    model, params, loss = trecipes.train_hp_resnet(train_steps=3,
                                                   device="cpu")
    assert np.isfinite(loss) and isinstance(model, tb.RecurrentResNet)
    m = trecipes.eval_hp_resnet(model, params, "triangular", num_points=200,
                                device="cpu")
    assert set(m) == {"mre", "dtw"} and np.isfinite(m["mre"])
    data = trecipes.l96_data(num_points=120, device="cpu")
    out = trecipes.eval_l96_baseline("gru", train_steps=2, hidden=8,
                                     data=data, device="cpu")
    assert set(out) == {"interp_l1", "extrap_l1"}
    assert all(np.isfinite(v) for v in out.values())
