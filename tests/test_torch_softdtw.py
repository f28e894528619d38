"""The port's soft-DTW slice against JAX, on the CPU.

The plain versions of the wavefront kernels K5 (forward, soft and hard,
optionally with R) and K6 (the E-matrix backward), the diagonal layout,
``ops.soft_dtw`` / ``ops.dtw_distance``, the reference DP of
``core/losses.py`` and the Lyapunov helpers are held against the JAX
package on the same numpy-made inputs.  The Pallas kernels run in
interpret mode, as the JAX package's own tests run them.

Tolerances: soft-DTW values and R within 1e-5 of the peak (float32
rounding of the same recurrence); hard DTW 1e-5 (minima and sums only).
E-matrices and gradients 1e-4 relative with a 1e-5 floor, as the JAX
package's own oracle test: the child weights exp((R_c - R - D_c)/gamma)
subtract R values of the size of the accumulated cost, so their float32
rounding grows with |R|/gamma, and it compounds along the reverse sweep.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import losses as jlosses  # noqa: E402
from repro.core.twin import reference_trajectory  # noqa: E402
from repro.data import lorenz96 as jl96  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.softdtw import softdtw_bwd_pallas, softdtw_pallas  # noqa: E402
from repro_torch.core import losses as tlosses  # noqa: E402
from repro_torch.data import lorenz96 as tl96  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import softdtw as tk  # noqa: E402
from repro_torch.train import recipes as trecipes  # noqa: E402

# the shapes of tests/test_kernels.py (forward) and tests/test_gradients.py
# (backward)
FWD_SHAPES = [(1, 1, 1), (5, 5, 1), (50, 70, 2), (128, 128, 3),
              (300, 200, 1), (257, 513, 2)]
BWD_SHAPES = [(1, 1, 1, 1.0), (5, 5, 1, 0.5), (40, 60, 2, 0.5),
              (300, 200, 1, 1.0)]


def series(seed, B, n, m, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, n, d)).astype(np.float32),
            rng.standard_normal((B, m, d)).astype(np.float32))


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def of_peak(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def jax_slab(x, y):
    """JAX's padded diagonal slab of the costs, and its chunk."""
    n, m = x.shape[1], y.shape[1]
    D = jax.vmap(jlosses._pairwise_dist)(jnp.asarray(x), jnp.asarray(y))
    chunk = jops._sdtw_chunk(n, m)
    return D, jops._diag_layout_batch(D, chunk), chunk


@pytest.mark.parametrize("n,m,d", FWD_SHAPES)
def test_diag_layout_and_undiag_match_jax_bitwise(n, m, d):
    x, y = series(n * m, 2, n, m, d)
    D, dd_j, _ = jax_slab(x, y)
    dd_t = tref.diag_layout(t(np.asarray(D))).contiguous()
    assert dd_t.shape == (2, n + m - 1, n) and dd_t.is_contiguous()
    # JAX pads to a chunk multiple with BIG rows; the port does not
    np.testing.assert_array_equal(dd_t.numpy(),
                                  np.asarray(dd_j)[:, :n + m - 1])
    np.testing.assert_array_equal(tref.diag_layout(t(np.asarray(D[0]))),
                                  np.asarray(jref.diag_layout(D[0])))
    back = tref.undiag_layout(dd_t, n, m)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jops._undiag_batch(dd_j, n, m)))
    np.testing.assert_array_equal(back.numpy(), np.asarray(D))


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
@pytest.mark.parametrize("gamma", [0.1, 0.7])
@pytest.mark.parametrize("n,m,d", FWD_SHAPES)
def test_plain_k5_matches_pallas(n, m, d, gamma, hard):
    """Value and the unpadded R of the plain K5 against ``softdtw_pallas``
    on the same slab."""
    x, y = series(n * m + d, 2, n, m, d)
    D, dd_j, chunk = jax_slab(x, y)
    want, r_j = softdtw_pallas(dd_j, n, m, gamma=gamma, hard=hard,
                               chunk=chunk, return_r=True)
    dd_t = t(np.asarray(dd_j)[:, :n + m - 1])
    got, r_t = tk.softdtw_wavefront(dd_t, n, m, gamma=gamma, hard=hard,
                                    return_r=True)
    assert got.shape == (2,) and r_t.shape == dd_t.shape
    assert of_peak(got, want) <= 1e-5
    assert of_peak(r_t, np.asarray(r_j)[:, :n + m - 1]) <= 1e-5
    only = tk.softdtw_wavefront(dd_t, n, m, gamma=gamma, hard=hard)
    np.testing.assert_array_equal(only.numpy(), got.numpy())


@pytest.mark.parametrize("n,m,d,gamma", BWD_SHAPES)
def test_plain_k6_matches_pallas(n, m, d, gamma):
    x, y = series(n * m + 7, 2, n, m, d)
    _, dd_j, chunk = jax_slab(x, y)
    _, r_j = softdtw_pallas(dd_j, n, m, gamma=gamma, chunk=chunk,
                            return_r=True)
    want = softdtw_bwd_pallas(dd_j, r_j, n, m, gamma=gamma, chunk=chunk)
    kd = n + m - 1
    got = tk.softdtw_wavefront_bwd(t(np.asarray(dd_j)[:, :kd]),
                                   t(np.asarray(r_j)[:, :kd]), n, m,
                                   gamma=gamma)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :kd],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("gamma", [0.1, 0.7])
def test_plain_k6_matches_float64_oracle(gamma):
    """The plain K6 on the plain K5's R against the float64 numpy reverse
    DP (17 x 23, the JAX package's oracle case; and gamma 0.1, the
    training objective's)."""
    x, y = series(3, 1, 17, 23, 2)
    D = tlosses._pairwise_dist(t(x), t(y))
    dd = tref.diag_layout(D).contiguous()
    _, rd = tk.softdtw_wavefront(dd, 17, 23, gamma=gamma, return_r=True)
    E = tref.undiag_layout(tk.softdtw_wavefront_bwd(dd, rd, 17, 23,
                                                    gamma=gamma), 17, 23)[0]
    want = tref.softdtw_grad_ref(D[0].numpy(), gamma)
    np.testing.assert_allclose(E.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(want, jref.softdtw_grad_ref(
        np.asarray(D[0]), gamma), rtol=1e-12, atol=0)
    assert float(E.min()) >= 0.0 and float(E[-1, -1]) == 1.0


@pytest.mark.parametrize("n,m,d,gamma", BWD_SHAPES)
def test_ops_soft_dtw_value_and_gradients_match_jax(n, m, d, gamma):
    x, y = series(n * m + d + 11, 2, n, m, d)
    g_out = np.array([1.0, -0.5], np.float32)

    def j_loss(a, b):
        return jnp.sum(jops.soft_dtw(a, b, gamma, True, "f32") * g_out)

    want = jops.soft_dtw(jnp.asarray(x), jnp.asarray(y), gamma, True, "f32")
    gx_j, gy_j = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(x),
                                                  jnp.asarray(y))
    tx, ty = t(x).requires_grad_(), t(y).requires_grad_()
    got = tops.soft_dtw(tx, ty, gamma)
    (got * t(g_out)).sum().backward()
    assert of_peak(got.detach(), want) <= 1e-5
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx_j),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(gy_j),
                               rtol=1e-4, atol=1e-5)


def test_ops_soft_dtw_gradients_at_the_training_gamma():
    """gamma = 0.1, the training objective's, at 40 x 60 x 2: the child
    weights' float32 rounding grows with |R|/gamma (|R| reaches 160
    here), so each package's E-matrix is off the float64 oracle by
    1e-4 to 7e-4 of its peak (1), the Pallas sweep the farther
    (measured).  The port's E is held to the oracle at 2.5e-4 (measured
    1.2e-4), and its gradients to JAX's at 2e-3 of their peak, the sum
    of the two packages' distances from the oracle with room (measured
    6.9e-4)."""
    n, m, d, gamma = 40, 60, 2, 0.1
    x, y = series(n * m + d + 11, 2, n, m, d)
    gx_j, gy_j = jax.grad(
        lambda a, b: jnp.sum(jops.soft_dtw(a, b, gamma, True, "f32")),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx, ty = t(x).requires_grad_(), t(y).requires_grad_()
    tops.soft_dtw(tx, ty, gamma).sum().backward()
    assert of_peak(tx.grad, gx_j) <= 2e-3
    assert of_peak(ty.grad, gy_j) <= 2e-3
    D = tlosses._pairwise_dist(t(x), t(y))
    dd = tref.diag_layout(D).contiguous()
    _, rd = tk.softdtw_wavefront(dd, n, m, gamma=gamma, return_r=True)
    E = tref.undiag_layout(tk.softdtw_wavefront_bwd(dd, rd, n, m,
                                                    gamma=gamma), n, m)
    for b in range(2):
        want = tref.softdtw_grad_ref(D[b].numpy(), gamma)
        assert float(np.max(np.abs(E[b].numpy() - want))) <= 2.5e-4


@pytest.mark.parametrize("n,m,d", FWD_SHAPES)
def test_ops_dtw_distance_matches_jax(n, m, d):
    x, y = series(n + m, 2, n, m, d)
    want = jops.dtw_distance(jnp.asarray(x), jnp.asarray(y))
    got = tops.dtw_distance(t(x), t(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the kernel's metric and the reference DP's agree
    ref_dtw = torch.stack([tlosses.dtw(a, b) for a, b in zip(t(x), t(y))])
    np.testing.assert_allclose(got.numpy(), ref_dtw.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_dtw_identity_is_zero():
    x, _ = series(1, 1, 64, 1, 2)
    assert float(tops.dtw_distance(t(x), t(x))[0]) == pytest.approx(
        0.0, abs=1e-6)


@pytest.mark.parametrize("n,m,d,gamma", [(5, 5, 1, 0.5), (40, 60, 2, 0.1),
                                         (30, 30, 0, 1.0)])
def test_losses_soft_dtw_and_batch_match_jax(n, m, d, gamma):
    """The reference DP (the digital substrate's objective) and its
    autograd gradient against JAX's and ``jax.grad``; d = 0 stands for
    1-D series of shape (n,).  At gamma 0.1 the two autodiffs' float32
    rounding grows with |R|/gamma as in the kernels' E-matrix: there the
    gradients are held to 5e-4 of their peak (measured 9.3e-5)."""
    x, y = series(n * m + 5, 3, n, m, max(d, 1))
    if d == 0:
        x, y = x[..., 0], y[..., 0]
    want = jlosses.soft_dtw_batch(jnp.asarray(x), jnp.asarray(y), gamma)
    gx_j = jax.grad(lambda a: jnp.sum(jlosses.soft_dtw_batch(
        a, jnp.asarray(y), gamma)))(jnp.asarray(x))
    tx = t(x).requires_grad_()
    got = tlosses.soft_dtw_batch(tx, t(y), gamma)
    got.sum().backward()
    assert got.shape == (3,)
    assert of_peak(got.detach(), want) <= 1e-5
    if gamma >= 0.5:
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx_j),
                                   rtol=1e-4, atol=1e-5)
    else:
        assert of_peak(tx.grad, gx_j) <= 5e-4
    with torch.no_grad():
        one = tlosses.soft_dtw(t(x[1]), t(y[1]), gamma)
    assert float(one) == pytest.approx(float(got[1].detach()), rel=1e-6)
    assert float(one) == pytest.approx(float(jlosses.soft_dtw(
        jnp.asarray(x[1]), jnp.asarray(y[1]), gamma)), rel=1e-5)
    # the plain references of the kernel module agree with the DP
    D = tlosses._pairwise_dist(t(x) if d else t(x)[..., None],
                               t(y) if d else t(y)[..., None])
    np.testing.assert_allclose(tref.softdtw_batch_ref(D, gamma).numpy(),
                               got.detach().numpy(), rtol=1e-6)
    np.testing.assert_allclose(tref.softdtw_ref(D[0], gamma, hard=True),
                               np.asarray(jref.softdtw_ref(
                                   jnp.asarray(D[0].numpy()), gamma,
                                   hard=True)), rtol=1e-6)


def test_soft_dtw_refuses_what_it_does_not_take():
    """Both bf16 policies are taken (the cost matrix rounded to bf16, as
    the JAX kernel's slab: its value to float32 rounding of JAX's); an
    unknown policy and a diagonal layout of the wrong shape still raise."""
    x, y = series(0, 2, 6, 7, 1)
    for policy in ("bf16", "bf16_f32acc"):
        got = tops.soft_dtw(t(x), t(y), 0.1, precision=policy)
        want = np.asarray(jops.soft_dtw(jnp.asarray(x), jnp.asarray(y), 0.1,
                                        True, policy))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    with pytest.raises(ValueError, match="unknown precision"):
        tops.soft_dtw(t(x), t(y), 0.1, precision="fp8")
    dd = tref.diag_layout(tlosses._pairwise_dist(t(x), t(y))).contiguous()
    with pytest.raises(ValueError, match="diagonal layout"):
        tk.softdtw_wavefront(dd, 7, 6)
    with pytest.raises(ValueError, match="float32"):
        tk.softdtw_wavefront(dd.double(), 6, 7)
    with pytest.raises(ValueError, match="contiguous"):
        tk.softdtw_wavefront(dd.transpose(0, 1).contiguous()
                             .transpose(0, 1), 6, 7)
    with pytest.raises(ValueError, match="gamma"):
        tk.softdtw_wavefront(dd, 6, 7, gamma=0.0)
    with pytest.raises(ValueError, match="differ"):
        tk.softdtw_wavefront_bwd(dd, dd[:1].contiguous(), 6, 7)
    with pytest.raises(ValueError, match="on meta"):
        tk.softdtw_wavefront(dd.to("meta"), 6, 7)


def test_autograd_function_uses_the_kernel_pair():
    """``ops.soft_dtw`` runs one K5 forward with R and one K6 backward
    per call; CPU tensors take the plain versions, which count nothing."""
    x, y = series(5, 2, 8, 9, 2)
    tx = t(x).requires_grad_()
    before = (tk.LAUNCHES, tk.BWD_LAUNCHES)
    tops.soft_dtw(tx, t(y), 0.1).sum().backward()
    assert (tk.LAUNCHES, tk.BWD_LAUNCHES) == before
    D = tlosses._pairwise_dist(t(x), t(y)).requires_grad_()
    tops.SoftDTW.apply(D, 0.1).sum().backward()
    dd = tref.diag_layout(D.detach()).contiguous()
    _, rd = tref.softdtw_wavefront_ref(dd, 8, 9, gamma=0.1, return_r=True)
    E = tref.undiag_layout(tref.softdtw_wavefront_bwd_ref(dd, rd, 8, 9,
                                                          gamma=0.1), 8, 9)
    np.testing.assert_array_equal(D.grad.numpy(), E.numpy())


# ---------------------------------------------------------------------------
# row-major entry points (what the kernels take since the slab was dropped)
# ---------------------------------------------------------------------------

ROW_SHAPES = [(1, 1), (5, 5), (7, 3), (3, 7), (61, 61)]


def row_costs(seed, n, m, planted=False):
    """(2, n, m) pairwise costs of seeded 2-D series; ``planted`` sets one
    in-matrix cost above BIG_CUT and one at it (invalid cells)."""
    x, y = series(seed, 2, n, m, 2)
    D = tlosses._pairwise_dist(t(x), t(y)).contiguous()
    if planted:
        D[0, n // 2, m // 3] = 2 * tref.BIG
        D[1, n - 1, m // 2] = tref.BIG_CUT
    return D


@pytest.mark.parametrize("planted", [False, True], ids=["clean", "planted"])
@pytest.mark.parametrize("gamma", [0.1, 0.7])
@pytest.mark.parametrize("n,m", ROW_SHAPES)
def test_rowmajor_plain_versions_match_diagonal_ones_bitwise(n, m, gamma,
                                                             planted):
    """Answer, R, hard answer and E of the row-major entry points (on the
    CPU: their plain versions) are the diagonal-layout plain versions'
    through ``diag_layout`` and the gather, bit for bit."""
    D = row_costs(n * m + 3, n, m, planted and n * m > 1)
    dd = tref.diag_layout(D).contiguous()
    ans, R = tk.softdtw_rowmajor(D, gamma=gamma, return_r=True)
    d_ans, d_r = tref.softdtw_wavefront_ref(dd, n, m, gamma=gamma,
                                            return_r=True)
    assert R.shape == D.shape and ans.shape == (2,)
    assert torch.equal(ans, d_ans)
    assert torch.equal(R, tref.undiag_layout(d_r, n, m))
    assert torch.equal(tk.softdtw_rowmajor(D, gamma=gamma), ans)
    assert torch.equal(tk.softdtw_rowmajor(D, hard=True),
                       tref.softdtw_wavefront_ref(dd, n, m, hard=True))
    E = tk.softdtw_rowmajor_bwd(D, R, gamma=gamma)
    d_e = tref.softdtw_wavefront_bwd_ref(dd, d_r, n, m, gamma=gamma)
    assert torch.equal(E, tref.undiag_layout(d_e, n, m))
    # the diagonal adapters lay the same values out again
    assert torch.equal(tref.diag_layout(E, fill=0.0), d_e)
    if planted and n * m > 1:
        assert float(R[0, n // 2, m // 3]) == tref.BIG
        assert float(E[0, n // 2, m // 3]) == 0.0
        assert float(E[1, n - 1, m // 2]) == 0.0


@pytest.mark.parametrize("gamma", [0.1, 0.7])
@pytest.mark.parametrize("n,m", ROW_SHAPES)
def test_rowmajor_entry_points_match_pallas(n, m, gamma):
    """The row-major answer, R and hard answer against ``softdtw_pallas``
    in interpret mode on the same costs, each within 1e-5 of its peak.  E
    against ``softdtw_bwd_pallas`` and the float64 oracle: the child
    weights exp((R_c - R - D_c)/gamma) carry float32 rounding that grows
    with |R|/gamma and along the sweep, and each package rounds its own
    way, so 1e-5 of the peak holds only for the small shapes; at
    (61, 61), gamma 0.1, the port's E is 4.1e-4 of its peak off the
    oracle and the Pallas E 6.6e-4 (measured).  Bounds: the port to the
    oracle 1e-3, the port to Pallas 2e-3 (measured 1.1e-3), and 5e-5
    wherever n * m <= 25 (measured 2.9e-5 at (7, 3), gamma 0.1)."""
    x, y = series(n * m + 17, 2, n, m, 2)
    D, dd_j, chunk = jax_slab(x, y)
    want, r_j = softdtw_pallas(dd_j, n, m, gamma=gamma, chunk=chunk,
                               return_r=True)
    want_h = softdtw_pallas(dd_j, n, m, hard=True, chunk=chunk)
    e_j = softdtw_bwd_pallas(dd_j, r_j, n, m, gamma=gamma, chunk=chunk)
    kd = n + m - 1
    D_t = t(np.asarray(D)).contiguous()
    got, R = tk.softdtw_rowmajor(D_t, gamma=gamma, return_r=True)
    E = tk.softdtw_rowmajor_bwd(D_t, R, gamma=gamma)
    assert of_peak(got, want) <= 1e-5
    assert of_peak(R, tref.undiag_layout(t(np.asarray(r_j)[:, :kd]), n,
                                         m)) <= 1e-5
    assert of_peak(tk.softdtw_rowmajor(D_t, hard=True), want_h) <= 1e-5
    e_pallas = of_peak(E, tref.undiag_layout(t(np.asarray(e_j)[:, :kd]),
                                             n, m))
    e_oracle = of_peak(E, np.stack([tref.softdtw_grad_ref(D_t[b].numpy(),
                                                          gamma)
                                    for b in range(2)]))
    assert e_pallas <= (5e-5 if n * m <= 25 else 2e-3)
    assert e_oracle <= 1e-3


@pytest.mark.parametrize("n,m,d", [(61, 61, 6), (40, 60, 2)])
def test_ops_soft_dtw_rowmajor_gradients_at_the_training_gamma(n, m, d):
    """``ops.soft_dtw`` (row-major K5 + K6) at gamma 0.1, the training
    objective's, against ``jax.grad`` of the JAX package's kernel path and
    the float64 gradient (the float64 oracle's E through the pairwise
    cost's autograd).  The value within 1e-5 of its peak.  The port's
    gradients within 1e-3 of the float64 peak (measured <= 3.1e-4); JAX's
    own within 5e-3 (measured 3.5e-3 at (61, 61, 6): its E-matrix's
    rounding, as in ``test_ops_soft_dtw_gradients_at_the_training_gamma``),
    so the port and JAX within 6e-3 of each other (measured 3.7e-3).  The
    gradient through D is g * E of the row-major backward, bitwise."""
    x, y = series(n * m + d, 2, n, m, d)
    gamma = 0.1
    want = jops.soft_dtw(jnp.asarray(x), jnp.asarray(y), gamma, True, "f32")
    gx_j, gy_j = jax.grad(
        lambda a, b: jnp.sum(jops.soft_dtw(a, b, gamma, True, "f32")),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx, ty = t(x).requires_grad_(), t(y).requires_grad_()
    got = tops.soft_dtw(tx, ty, gamma)
    got.sum().backward()
    x64 = t(x).double().requires_grad_()
    y64 = t(y).double().requires_grad_()
    D64 = tlosses._pairwise_dist(x64, y64)
    D64.backward(torch.from_numpy(np.stack([
        tref.softdtw_grad_ref(D64[b].detach().numpy(), gamma)
        for b in range(2)])))
    assert of_peak(got.detach(), want) <= 1e-5
    for port, jax_g, truth in ((tx.grad, gx_j, x64.grad),
                               (ty.grad, gy_j, y64.grad)):
        assert of_peak(port, truth) <= 1e-3
        assert of_peak(np.asarray(jax_g), truth) <= 5e-3
        assert of_peak(port, jax_g) <= 6e-3
    D = tlosses._pairwise_dist(t(x), t(y)).requires_grad_()
    tops.SoftDTW.apply(D, gamma).backward(torch.tensor([1.0, -0.5]))
    _, R = tk.softdtw_rowmajor(D.detach(), gamma=gamma, return_r=True)
    E = tk.softdtw_rowmajor_bwd(D.detach(), R, gamma=gamma)
    assert torch.equal(D.grad, torch.tensor([1.0, -0.5])[:, None, None] * E)


def test_rowmajor_entry_points_refuse_what_the_diagonal_ones_refuse():
    D = row_costs(0, 6, 7)
    _, R = tk.softdtw_rowmajor(D, gamma=0.1, return_r=True)
    for fn, args in ((tk.softdtw_rowmajor, (D,)),
                     (tk.softdtw_rowmajor_bwd, (D, R))):
        with pytest.raises(ValueError, match="float32"):
            fn(*(a.double() for a in args))
        with pytest.raises(ValueError, match="contiguous"):
            fn(*(a.transpose(1, 2).contiguous().transpose(1, 2)
                 for a in args))
        for gamma in (0.0, -1.0):
            with pytest.raises(ValueError, match="gamma"):
                fn(*args, gamma=gamma)
        with pytest.raises(ValueError, match="on meta"):
            fn(*(a.to("meta") for a in args))
        with pytest.raises(ValueError, match=r"\(B, n, m\)"):
            fn(*(a[0] for a in args))
    with pytest.raises(ValueError, match="differ"):
        tk.softdtw_rowmajor_bwd(D, R[:1].contiguous())
    with pytest.raises(ValueError, match="differ"):
        tk.softdtw_rowmajor_bwd(D, R[:, :, :6].contiguous())


def test_band_warps_and_row_limit():
    """One band of one row a thread up to 256 rows (8 warps), bands of 256
    beyond; the CUDA path's row limit is checked before any launch."""
    assert [tk.band_warps(n) for n in (1, 32, 33, 61, 201, 256, 257, 4096)
            ] == [1, 1, 2, 2, 7, 8, 8, 8]
    assert tk.MAX_ROWS == 4096
    with pytest.raises(ValueError, match="at most 4096 rows"):
        tk._check_rows("softdtw_rowmajor", tk.MAX_ROWS + 1,
                       torch.device("cuda"))
    tk._check_rows("softdtw_rowmajor", tk.MAX_ROWS, torch.device("cuda"))


# ---------------------------------------------------------------------------
# Lyapunov helpers
# ---------------------------------------------------------------------------

def test_lyapunov_block_loop_matches_jax_from_its_direction():
    """The port's block loop from JAX's state and JAX's start direction
    (``jax.random.normal`` of the default key, recomputed here) over 200
    RK4 steps, 10 renormalisations, at eps = 1e-2.  The two packages
    round the state and its perturbation differently (XLA fuses the
    field), and each block's log growth reads that rounding relative to
    eps: ~ulp(|y|) * sqrt(20 steps) / eps, 2e-4 at eps = 1e-2 (measured
    3e-5 rel on the estimate; bound 1e-4), 2e-3 at eps = 1e-3.  At the
    default eps = 1e-6 the perturbation is 1-2 ulp of the state and both
    packages measure rounding noise (ROADMAP.md, queue 3)."""
    f_j = jl96.lorenz96_field(8.0)
    ys = reference_trajectory(
        f_j, jl96.PAPER_Y0, jnp.arange(500) * 0.02, steps_per_interval=8)
    y0 = np.asarray(ys[-1])
    want = jlosses.max_lyapunov_exponent(f_j, ys[-1], None, dt=0.01,
                                         num_steps=200, renorm_every=20,
                                         eps=1e-2)
    direction = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (6,),
                                             jnp.float32))
    got = tlosses._mle_from_direction(tl96.lorenz96_field(8.0), t(y0), None,
                                      0.01, 200, 20, 1e-2, t(direction))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=1e-4)
    assert float(tlosses.lyapunov_time(got)) == pytest.approx(
        float(jlosses.lyapunov_time(want)), rel=1e-4)


def test_l96_lyapunov_info_matches_jax_estimate():
    """``l96_lyapunov_info`` (float64 in the port) against the JAX
    package's estimate where float32 resolves its perturbation
    (eps = 1e-4, otherwise as ``recipes.l96_lyapunov_info``).  The two
    run 200 time units along different sample paths of the attractor —
    the spin-ups part after ~10 Lyapunov times — so they agree to the
    estimator's statistical spread: measured 0.934 (JAX) against 1.063
    (port), 14% apart; bound 20%.  JAX's own ``l96_lyapunov_info`` at
    eps = 1e-6 reports 2.198, rounding noise (ROADMAP.md, queue 3)."""
    got = trecipes.l96_lyapunov_info(device="cpu")
    f_j = jl96.lorenz96_field(8.0)
    ys = reference_trajectory(
        f_j, jl96.PAPER_Y0, jnp.arange(500) * 0.02, steps_per_interval=8)
    want = float(jlosses.max_lyapunov_exponent(
        f_j, ys[-1], None, dt=0.01, num_steps=20000, renorm_every=20,
        eps=1e-4))
    assert got["mle"] == pytest.approx(want, rel=0.2)
    assert got["lyapunov_time"] == pytest.approx(1.0 / got["mle"], rel=1e-6)
