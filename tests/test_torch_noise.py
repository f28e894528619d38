"""The port's counter noise stream (K3, ``repro_torch.kernels.noise``) against JAX.

On the CPU the functions run K3's plain versions, which hold uint32
values in int64 tensors.  Hash bits, uniforms and stuck masks must be
the JAX package's bit for bit, at row/column offsets and at salts above
2^31; normals within 1e-6 absolute (the re-anchor probe measured 4.8e-7
from ``log``/``cos`` rounding).  The CUDA fill kernel is held against
the same plain versions on the card by ``chip_smoke.py``.

Both packages' reference normals are computed in a fresh process: once,
in a whole-suite run where other files had run first in the same
worker, one normal came out 3.8e-5 away (not reproduced since, alone or
after those files); a failure now says which package moved.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import faults as jfaults  # noqa: E402
from repro.kernels import noise as jn  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.kernels import noise as tn  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

NORMAL_ATOL = 1e-6
SALTS = [0, 5, 0x0F00_0003, 0x0F00_0003 + 0x0080_0000, 2 ** 31 + 12345,
         0xFF00_0000]
NORMAL_SHAPES = [(128, 128), (3, 5, 7)]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fresh_normals(tmp_path_factory):
    """{(package, salt, shape): normals} from one fresh process."""
    out = tmp_path_factory.mktemp("normals") / "normals.npz"
    code = textwrap.dedent(f"""
        import numpy as np
        from repro.kernels import noise as jn
        from repro_torch.kernels import noise as tn
        res = {{}}
        for salt in {SALTS!r}:
            for shape in {NORMAL_SHAPES!r}:
                key = f"{{salt}}_{{'x'.join(map(str, shape))}}"
                res["jax_" + key] = np.asarray(jn.counter_normal(11, salt,
                                                                 shape))
                res["torch_" + key] = tn.counter_normal(
                    11, salt, shape, device="cpu").numpy()
        np.savez({str(out)!r}, **res)
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def check_normals(fresh, salt, shape):
    key = f"{salt}_{'x'.join(map(str, shape))}"
    want = fresh["jax_" + key]
    got = tn.counter_normal(11, salt, shape, device="cpu").numpy()
    err = float(np.abs(got - want).max())
    moved = float(np.abs(got - fresh["torch_" + key]).max())
    assert err <= NORMAL_ATOL, (
        f"port vs JAX normals {err:.3e}; this process's port normals moved "
        f"{moved:.3e} from a fresh process's")
    return got


def u32(x):
    """A numpy/JAX uint32 array as int64 for comparison with the port."""
    return np.asarray(x).astype(np.uint32).astype(np.int64)


def bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def test_splitmix32_is_bitwise_jax():
    x = np.random.default_rng(0).integers(0, 2 ** 32, (96, 80),
                                          dtype=np.uint64)
    want = u32(jn.splitmix32(jnp.asarray(x.astype(np.uint32))))
    got = tn.splitmix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    # bits above 32 are dropped, as a uint32 conversion drops them
    hi = torch.from_numpy(x.astype(np.int64)) + (1 << 40)
    np.testing.assert_array_equal(tn.splitmix32(hi).numpy(), want)


@pytest.mark.parametrize("salt", SALTS)
def test_counter_uniform_at_is_bitwise_jax(salt):
    idx = jn.global_cell_index((33, 40), 7, 3, 100)
    want = jn.counter_uniform_at(11, salt, idx)
    got = tn.counter_uniform_at(11, salt,
                                tn.global_cell_index((33, 40), 7, 3, 100))
    np.testing.assert_array_equal(u32(idx),
                                  tn.global_cell_index((33, 40), 7, 3,
                                                       100).numpy())
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))
    assert float(got.min()) > 0.0 and float(got.max()) <= 1.0


@pytest.mark.parametrize("salt", SALTS)
@pytest.mark.parametrize("offset", [(0, 0, None), (16, 32, 48),
                                    (1000, 7, 513)])
def test_stuck_cell_masks_are_bitwise_jax(salt, offset):
    row0, col0, ncols = offset
    shape = (24, 40) if ncols is None else (8, 16)
    js, jo = jn.stuck_cell_masks(9, salt, shape, 0.2, 0.4, row0=row0,
                                 col0=col0, ncols=ncols)
    ts, to = tn.stuck_cell_masks(9, salt, shape, 0.2, 0.4, row0=row0,
                                 col0=col0, ncols=ncols, device="cpu")
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def test_stuck_masks_tiling_independent():
    full, full_on = tn.stuck_cell_masks(9, 17, (32, 48), 0.2, 0.4,
                                        device="cpu")
    blk, blk_on = tn.stuck_cell_masks(9, 17, (8, 16), 0.2, 0.4, row0=16,
                                      col0=32, ncols=48, device="cpu")
    assert torch.equal(full[16:24, 32:48], blk)
    assert torch.equal(full_on[16:24, 32:48], blk_on)


@pytest.mark.parametrize("salt", SALTS)
def test_counter_normal_within_1e6_of_jax(fresh_normals, salt):
    got = check_normals(fresh_normals, salt, (128, 128))
    assert abs(float(got.mean())) < 0.05 and abs(float(got.std()) - 1) < 0.05


def test_counter_normal_at_matches_counter_normal_and_rank3(fresh_normals):
    """The element-id form (K7's per-tile salts) equals the shape form at
    the row-major ids; a 3-D shape flattens row-major like JAX's iotas."""
    a = tref.counter_normal_at_ref(4, 77, torch.arange(12 * 9).reshape(12, 9))
    b = tn.counter_normal(4, 77, (12, 9), device="cpu")
    assert torch.equal(a, b)
    check_normals(fresh_normals, 5, (3, 5, 7))


def test_apply_stuck_matches_jax_in_both_spaces():
    g = np.linspace(20e-6, 100e-6, 30 * 20, dtype=np.float32).reshape(30, 20)
    salt = jfaults.fault_salt(2, 1)
    assert salt == tfaults.fault_salt(2, 1)
    want = jfaults.apply_stuck(jnp.asarray(g), 5, salt, 0.3, 0.5, 100e-6,
                               20e-6)
    got = tfaults.apply_stuck(torch.from_numpy(g), 5, salt, 0.3, 0.5,
                              100e-6, 20e-6)
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))
    # idempotent, and the level-index representation pins at 63 / 0
    assert torch.equal(tfaults.apply_stuck(got, 5, salt, 0.3, 0.5, 100e-6,
                                           20e-6), got)
    idx = torch.arange(600, dtype=torch.float32).reshape(30, 20) % 64
    lv = tfaults.apply_stuck(idx, 5, salt, 0.3, 0.5, 63, 0)
    jlv = jfaults.apply_stuck(jnp.asarray(idx.numpy()), 5, salt, 0.3, 0.5,
                              63, 0)
    np.testing.assert_array_equal(lv.numpy(), np.asarray(jlv))


MANY = [(0x0F00_0000, (7, 64)), (0x0F00_0001, (7, 64)),
        (0x0F00_0002, (65, 64)), (2 ** 31 + 12345, (65, 6)),
        (0xFFFF_FFF0, (100, 70)), (5, (1, 1))]


def test_stuck_cell_masks_many_is_bitwise_per_array_and_jax():
    """The batched masks (K3's one-launch programming fill) are each array's
    own masks, as the per-array fill and the JAX package draw them, salts
    past 2^31 and near 2^32 (the polarity salt wraps) included."""
    got = tn.stuck_cell_masks_many(9, MANY, 0.2, 0.4, device="cpu")
    assert len(got) == len(MANY)
    for (salt, shape), (ts, to) in zip(MANY, got):
        assert tuple(ts.shape) == shape and ts.dtype == torch.bool
        one = tn.stuck_cell_masks(9, salt, shape, 0.2, 0.4, device="cpu")
        assert torch.equal(ts, one[0]) and torch.equal(to, one[1])
        js, jo = jn.stuck_cell_masks(9, jnp.uint32(salt), shape, 0.2, 0.4)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert tn.MASK_LAUNCHES == 0 and tn.LAUNCHES == 0


def test_stuck_masks_of_draws_every_layer_and_pair():
    fm = tfaults.make_fault_model(("stuck", dict(rate=0.3, on_frac=0.7)),
                                  seed=4)
    shapes = [(3, 14), (15, 14), (15, 1)]
    masks = tfaults.stuck_masks_of(fm, shapes, "cpu", layer0=1)
    for i, (shape, pair_masks) in enumerate(zip(shapes, masks)):
        for pair, (ts, to) in enumerate(pair_masks):
            js, jo = jn.stuck_cell_masks(4, jfaults.fault_salt(1 + i, pair),
                                         shape, 0.3, 0.7)
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
            np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert tfaults.stuck_masks_of(None, shapes, "cpu") is None
    assert tfaults.stuck_masks_of(tfaults.make_fault_model("drift"), shapes,
                                  "cpu") is None


def test_shape_functions_default_to_cuda_and_ids_must_be_integers():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tn.counter_normal(0, 0, (4, 4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tn.stuck_cell_masks(0, 0, (4, 4), 0.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tn.stuck_cell_masks_many(0, [(0, (4, 4))], 0.1)
    with pytest.raises(ValueError, match="integers"):
        tn.counter_uniform_at(0, 0, torch.zeros(3))
    with pytest.raises(ValueError, match="meta"):
        tn.counter_uniform_at(0, 0, torch.zeros(3, dtype=torch.int64,
                                                device="meta"))
