"""The port's fused analogue rollout (K4, ``repro_torch.kernels.fused_analogue``) against JAX.

On the CPU the wrapper runs K4's plain version; these tests hold it
against the JAX package's Pallas kernel (interpret mode) on one
JAX-programmed noisy array carried over by ``interop.progs_from_numpy``,
within 1e-5 of the trajectory's peak (measured ~3e-8): both storage
modes, the noise-free path and read noise 0.02 (the counter stream is
bitwise, the normals within ~5e-7), stuck cells plus drift, shared /
per-twin / autonomous drives, and ``step_offset``.  Inside the port a
split-and-resume noisy rollout is bitwise the unsplit one and two calls
are bitwise equal.  The plain version of K4's read-noise pre-pass is
bitwise the noisy pairs the plain rollout reads, and within the
Box-Muller bound of pairs built from JAX's ``counter_normal``; K4's launch
geometry is K1's with a second weight block under read noise.  The CUDA
kernels are held against the plain versions on the card by
``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import analogue as jan  # noqa: E402
from repro.core.faults import FAULT_SALT_BASE  # noqa: E402
from repro.kernels import fused_analogue as jk4  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.interop import progs_from_numpy  # noqa: E402
from repro_torch.kernels import fused_analogue as tk4  # noqa: E402
from repro_torch.kernels import fused_ode_mlp as tk1  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = 1e-5
G_MIN, G_MAX = 20e-6, 100e-6
FAULT = {"stuck_rate": 0.1, "stuck_on_frac": 0.5, "fault_seed": 3,
         "salt_base": FAULT_SALT_BASE, "drift_nu": 0.02, "drift_tau": 100.0,
         "drift_n0": 40}


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def staged_arrays(sizes, storage, seed=0):
    """One JAX-programmed deployment, as JAX arrays and as the port's."""
    rng = np.random.default_rng(seed)
    params = [{"w": jnp.asarray((rng.standard_normal((a, b))
                                 * np.sqrt(2.0 / a)).astype(np.float32)),
               "b": jnp.asarray((0.1 * rng.standard_normal(b))
                                .astype(np.float32))}
              for a, b in zip(sizes[:-1], sizes[1:])]
    spec = jan.AnalogueSpec(prog_noise=0.0 if storage == "uint8" else 0.0436)
    progs = jan.program_mlp(jax.random.PRNGKey(seed), params, spec)
    if storage == "uint8":
        progs = [jan.stage_uint8(p, spec) for p in progs]
    ka, kb = ("gp_idx", "gm_idx") if storage == "uint8" else ("gp", "gm")
    jst = {"gps": [p[ka] for p in progs], "gms": [p[kb] for p in progs],
           "scales": jnp.stack([p["scale"] for p in progs]),
           "g_step": ((G_MAX - G_MIN) / 63 if storage == "uint8" else None),
           "g_min": G_MIN, "g_max": G_MAX}
    tprogs = progs_from_numpy(progs, "cpu")
    tst = dict(jst, gps=[p[ka] for p in tprogs], gms=[p[kb] for p in tprogs],
               scales=torch.stack([p["scale"] for p in tprogs]))
    return jst, tst


def inputs(sizes, B, T, drive, seed=1):
    rng = np.random.default_rng(seed)
    D = sizes[-1]
    du = sizes[0] - D
    y0 = (0.3 * rng.standard_normal((B, D))).astype(np.float32)
    th = np.linspace(0.0, 1.0, 2 * T + 1)
    if drive == "autonomous":
        u = np.zeros((2 * T + 1, 0), np.float32)
    elif drive == "shared":
        u = np.sin(2 * np.pi * 2.0 * th)[:, None].repeat(du, 1)
    else:
        amp = rng.uniform(0.5, 1.5, (B, 1))
        freq = rng.uniform(1.0, 4.0, (B, 1))
        u = (amp * np.sin(2 * np.pi * freq * th[None]))[..., None]
    return y0, u.astype(np.float32)


HP, L96 = (2, 14, 14, 1), (6, 16, 16, 6)
CASES = {
    # name: (sizes, storage, drive, B, T, dt, kernel kwargs)
    "hp_float_clean_shared": (HP, "float", "shared", 8, 20, 0.01, {}),
    "hp_uint8_clean_per_twin": (HP, "uint8", "per_twin", 8, 20, 0.01, {}),
    "hp_float_noise_per_twin": (HP, "float", "per_twin", 8, 16, 0.01,
                                dict(read_noise=0.02, noise_seed=5)),
    "hp_uint8_noise_stuck_drift": (HP, "uint8", "shared", 4, 12, 0.01,
                                   dict(read_noise=0.02, noise_seed=9,
                                        fault=FAULT)),
    "l96_float_stuck_drift_auto": (L96, "float", "autonomous", 8, 20, 0.0025,
                                   dict(fault=FAULT)),
    "l96_uint8_stuck_clamp_auto": (L96, "uint8", "autonomous", 8, 20, 0.0025,
                                   dict(fault=dict(FAULT, drift_nu=0.0),
                                        v_clamp=0.3)),
    "l96_float_noise_offset_auto": (L96, "float", "autonomous", 4, 10,
                                    0.0025, dict(read_noise=0.02,
                                                 noise_seed=2,
                                                 step_offset=37,
                                                 fault=FAULT)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_k4_matches_jax_kernel(case):
    sizes, storage, drive, B, T, dt, kw = CASES[case]
    jst, tst = staged_arrays(sizes, storage)
    y0, u = inputs(sizes, B, T, drive)
    common = dict(g_step=jst["g_step"], g_min=G_MIN, g_max=G_MAX, **kw)
    want = jk4.fused_analogue_rollout(jst["gps"], jst["gms"], jst["scales"],
                                      jnp.asarray(y0), jnp.asarray(u), dt,
                                      batch_tile=4, interpret=True, **common)
    got = tk4.fused_analogue_rollout(tst["gps"], tst["gms"], tst["scales"],
                                     t(y0), t(u), dt, batch_tile=4, **common)
    assert got.shape == (T + 1, B, sizes[-1]) and got.dtype == torch.float32
    assert rel(got.numpy(), want) <= TOL


def test_ops_wrapper_matches_jax_ops_and_is_detached():
    jst, tst = staged_arrays(HP, "float")
    y0, u = inputs(HP, 4, 10, "shared")
    jst["fault"] = tst["fault"] = FAULT
    want = jops.fused_analogue_rollout(jst, jnp.asarray(y0), jnp.asarray(u),
                                       0.01, batch_tile=2, read_noise=0.02,
                                       noise_seed=4, interpret=True)
    y0t = t(y0).requires_grad_()
    got = tops.fused_analogue_rollout(tst, y0t, t(u), 0.01, batch_tile=2,
                                      read_noise=0.02, noise_seed=4)
    assert rel(got.numpy(), want) <= TOL
    assert not got.requires_grad


def noisy_rollout(tst, y0, u, dt, **kw):
    return tk4.fused_analogue_rollout(
        tst["gps"], tst["gms"], tst["scales"], y0, u, dt,
        g_step=tst["g_step"], g_min=G_MIN, g_max=G_MAX, read_noise=0.02,
        noise_seed=7, fault=FAULT, batch_tile=4, **kw)


@pytest.mark.parametrize("storage", ["float", "uint8"])
def test_split_and_resume_is_bitwise_and_repeats_are_equal(storage):
    _, tst = staged_arrays(HP, storage)
    y0, u = inputs(HP, 4, 20, "per_twin")
    y0, u = t(y0), t(u)
    full = noisy_rollout(tst, y0, u, 0.01)
    assert torch.equal(full, noisy_rollout(tst, y0, u, 0.01))
    k = 7
    head = noisy_rollout(tst, y0, u[:, :2 * k + 1], 0.01)
    tail = noisy_rollout(tst, head[-1], u[:, 2 * k:], 0.01, step_offset=k)
    assert torch.equal(torch.cat([head, tail[1:]]), full)
    # without the offset the resumed half draws other noise
    other = noisy_rollout(tst, head[-1], u[:, 2 * k:], 0.01)
    assert not torch.equal(other, tail)


def test_float64_conductances_reach_the_rollout_as_float32(monkeypatch):
    """A hand-assembled float64 deployment is handed on as float32 (the
    kernel reads a float array's bytes as float32), to the kernel and the
    plain version alike, so it rolls out as its float32 copy."""
    _, tst = staged_arrays(HP, "float")
    y0, u = inputs(HP, 4, 8, "shared")
    want = tops.fused_analogue_rollout(tst, t(y0), t(u), 0.01, batch_tile=4,
                                       read_noise=0.02, noise_seed=3)
    f64 = dict(tst, gps=[g.double() for g in tst["gps"]],
               gms=[g.double() for g in tst["gms"]])
    seen = []
    plain = tk4.ref.fused_analogue_rollout_ref

    def spy(gps, gms, *args, **kw):
        seen.extend([*gps, *gms])
        return plain(gps, gms, *args, **kw)

    monkeypatch.setattr(tk4.ref, "fused_analogue_rollout_ref", spy)
    got = tops.fused_analogue_rollout(f64, t(y0), t(u), 0.01, batch_tile=4,
                                      read_noise=0.02, noise_seed=3)
    assert torch.equal(got, want)
    assert {g.dtype for g in seen} == {torch.float32}


def test_gradients_are_zero():
    _, tst = staged_arrays(HP, "float")
    y0, u = inputs(HP, 4, 8, "shared")
    y0t = t(y0).requires_grad_()
    out = tops.fused_analogue_rollout(tst, y0t, t(u), 0.01, batch_tile=4)
    assert out.grad_fn is None
    loss = (out ** 2).sum() + 0.0 * y0t.sum()
    loss.backward()
    assert float(y0t.grad.abs().max()) == 0.0


def test_shared_memory_check():
    # K1's block (op table, padded weight rows, activations, drive), with
    # a second weight block under read noise for the double-buffered pairs
    l96 = (6, 64, 64, 6)
    assert tk4.check_smem_fit(l96, False) == tk1.smem_bytes(l96)
    assert tk4.check_smem_fit(l96, True) == tk1.smem_bytes(l96) + 4 * (
        tk1.OPS_WORDS + 7 * 64 + 65 * 64 + 65 * 8)
    tk4.check_smem_fit((6, 128, 128, 6), True)
    tk4.check_smem_fit((6, 160, 160, 6), False)
    # the raw G+ and G- no longer stay resident beside the noisy scratch
    tk4.check_smem_fit((6, 160, 160, 6), True)
    with pytest.raises(ValueError, match="227 KB"):
        tk4.check_smem_fit((6, 176, 176, 6), True)
    with pytest.raises(ValueError, match="227 KB"):
        tk4.check_smem_fit((6, 512, 512, 6), False)


@pytest.mark.parametrize("sizes,B,noisy,twins,blocks,threads", [
    (HP, 1, False, 1, 1, 32),
    (HP, 1, True, 1, 1, 32),
    (HP, 100, True, 1, 100, 32),
    ((6, 64, 64, 6), 64, False, 1, 64, 128),
    ((6, 64, 64, 6), 1024, False, 4, 256, 128),
    ((6, 64, 64, 6), 1024, True, 4, 256, 128),
])
def test_launch_geometry_is_k1s_with_a_second_weight_block(
        sizes, B, noisy, twins, blocks, threads):
    """One twin per block at the HP shapes of P1, four at the fleet; the
    threads K1 gives the widest product; the shared memory K1's block plus,
    under read noise, the second weight block the pairs stream into."""
    g = tk4.launch_geometry(B, sizes, noisy)
    k1 = tk1.launch_geometry(B, sizes)
    assert (g.twins_per_block, g.blocks, g.threads) == (twins, blocks,
                                                        threads)
    assert (g.twins_per_block, g.blocks, g.threads, g.time_chunk) == (
        k1.twins_per_block, k1.blocks, k1.threads, k1.time_chunk)
    extra = 4 * tk1.weight_floats(sizes, False) if noisy else 0
    assert g.smem_bytes == k1.smem_bytes + extra
    assert tk4.noise_eval_floats(sizes) == tk1.weight_floats(
        sizes, False) - tk1.OPS_WORDS
    forced = tk4.launch_geometry(B, sizes, noisy, twins_per_block=4)
    assert forced.blocks == -(-B // 4)


@pytest.mark.parametrize("noisy", [False, True])
def test_launch_geometry_refuses_the_512_width(noisy):
    """The resident K4 still refuses 6->512->512->6 (check_smem_fit); the
    launch is now K4w's cluster geometry, K1w's, clean and under read
    noise (the noisy pairs stream into the weights' own buffers), at the
    scorecard's single twin and at the fleet, and the rollout runs (on the
    CPU the plain version)."""
    sizes = (6, 512, 512, 6)
    with pytest.raises(ValueError, match="227 KB"):
        tk4.check_smem_fit(sizes, noisy)
    for B in (1, 1024):
        geom = tk4.launch_geometry(B, sizes, noisy)
        assert geom == tk1.wide_geometry(B, sizes)
        assert geom.cluster == tk1.WIDE_CLUSTER
        assert geom.smem_bytes <= tk1.SMEM_LIMIT_BYTES
    assert tk4.launch_geometry(1024, sizes, noisy).twins_per_block == 4
    _, tst = staged_arrays(sizes, "float")
    y0 = 0.1 * torch.ones((4, 6))
    kw = dict(read_noise=0.02 if noisy else 0.0, g_min=G_MIN, g_max=G_MAX)
    got = tk4.fused_analogue_rollout(
        tst["gps"], tst["gms"], tst["scales"], y0, torch.zeros((3, 0)), 0.01,
        **kw)
    assert got.shape == (2, 4, 6) and bool(torch.isfinite(got).all())
    assert torch.equal(got, tref.fused_analogue_rollout_ref(
        tst["gps"], tst["gms"], tst["scales"], y0, torch.zeros((3, 0)),
        0.01, fault=dict(tk4.FAULT_DEFAULTS), **kw))


def test_noise_chunk_rule(monkeypatch):
    """A noisy time chunk holds at most NOISE_CHUNK_BYTES of pairs: the
    Lorenz96 fleet request's 200 steps are one chunk, P1's HP rollouts
    too."""
    per_step = 16 * tk4.noise_eval_floats((6, 64, 64, 6))
    assert per_step == 82_048
    assert tk4.noise_chunk_steps((6, 64, 64, 6)) == \
        tk4.NOISE_CHUNK_BYTES // per_step >= 200
    assert tk4.noise_chunk_steps(HP) >= 1000
    assert tk4.noise_chunk_steps((6, 512, 512, 6)) == 5
    monkeypatch.setattr(tk4, "NOISE_CHUNK_BYTES", per_step - 1)
    assert tk4.noise_chunk_steps((6, 64, 64, 6)) == 1


def _recorded_pairs(monkeypatch, storage, T, step_offset, fault):
    """{salt: S} of every noisy pair fused_analogue_rollout_ref reads."""
    _, tst = staged_arrays(HP, storage)
    y0, u = inputs(HP, 2, T, "shared")
    seen = {}
    pair = tref.noisy_pair_ref

    def spy(gp, gm, read_noise, noise_seed, salt):
        seen[salt] = pair(gp, gm, read_noise, noise_seed, salt)
        return seen[salt]

    monkeypatch.setattr(tref, "noisy_pair_ref", spy)
    tk4.fused_analogue_rollout(
        tst["gps"], tst["gms"], tst["scales"], t(y0), t(u), 0.01,
        g_step=tst["g_step"], g_min=G_MIN, g_max=G_MAX, read_noise=0.02,
        noise_seed=11, step_offset=step_offset, fault=fault, batch_tile=2)
    monkeypatch.setattr(tref, "noisy_pair_ref", pair)
    return tst, seen


@pytest.mark.parametrize("storage,step_offset,fault", [
    ("float", 0, None), ("uint8", 37, FAULT), ("uint8", 90_000_000, FAULT)])
def test_noise_pass_plain_is_the_rollouts_noisy_pairs(monkeypatch, storage,
                                                      step_offset, fault):
    """K4's pre-pass plain version is bitwise the S that the plain rollout
    reads at every (step, stage, layer), stuck cells and uint8 decoding
    included; the wrapper's CPU path is that plain version."""
    T = 3
    tst, seen = _recorded_pairs(monkeypatch, storage, T, step_offset, fault)
    kw = dict(read_noise=0.02, noise_seed=11, step_offset=step_offset,
              g_step=tst["g_step"], g_min=G_MIN, g_max=G_MAX)
    pairs = tref.fused_analogue_noisy_pairs_ref(
        tst["gps"], tst["gms"], T, fault=dict(tk4.FAULT_DEFAULTS,
                                              **(fault or {})), **kw)
    L = len(pairs)
    assert len(seen) == 4 * T * L
    for li, p in enumerate(pairs):
        assert p.shape == (T, 4, *tst["gps"][li].shape)
        for ti in range(T):
            for st in range(4):
                salt = (step_offset + ti) * 8 * L + st * 2 * L + 2 * li
                assert torch.equal(p[ti, st], seen[salt])
    got = tk4.noisy_pairs(tst["gps"], tst["gms"], T, fault=fault, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, pairs))


@pytest.mark.parametrize("step_offset", [0, 3, 90_000_000, 200_000_000])
def test_noise_pass_plain_agrees_with_jax_counter_normal(step_offset):
    """The pre-pass plain version against S built from JAX's
    ``counter_normal`` at the same salts (taken mod 2^32; the salts pass
    2^31 from step 90,000,000 and wrap from 200,000,000), in float32 in
    the same order: the normals differ by at most the Box-Muller bound
    of 1e-6, so S by at most that times read_noise times the
    conductances, plus an ulp of each rounding."""
    from repro.kernels import noise as jnoise
    jst, tst = staged_arrays(HP, "float")
    T, s = 2, 0.02
    pairs = tk4.noisy_pairs(tst["gps"], tst["gms"], T, read_noise=s,
                            noise_seed=5, step_offset=step_offset)
    L = len(pairs)
    f32 = np.float32
    for li, p in enumerate(pairs):
        a = np.asarray(jst["gps"][li], np.float32)
        b = np.asarray(jst["gms"][li], np.float32)
        for ti in range(T):
            for st in range(4):
                salt = (step_offset + ti) * 8 * L + st * 2 * L + 2 * li
                ep, em = (np.asarray(jnoise.counter_normal(
                    5, (salt + k) & 0xFFFF_FFFF, a.shape)) for k in (0, 1))
                want = (a * (f32(1) + f32(s) * ep)
                        - b * (f32(1) + f32(s) * em))
                got = p[ti, st].numpy()
                tol = ((np.abs(a) + np.abs(b)) * (s * 1e-6 + 2.0 ** -22)
                       + 2.0 ** -23 * np.abs(want))
                assert (np.abs(got - want) <= tol).all()


def test_noisy_pairs_argument_errors():
    _, tst = staged_arrays(HP, "float")
    with pytest.raises(ValueError, match="read noise"):
        tk4.noisy_pairs(tst["gps"], tst["gms"], 3, read_noise=0.0,
                        noise_seed=1)
    with pytest.raises(ValueError, match="read noise"):
        tk4.noisy_pairs(tst["gps"], tst["gms"], 0, read_noise=0.02,
                        noise_seed=1)


def test_forced_geometry_needs_the_card():
    _, tst = staged_arrays(HP, "float")
    y0, u = inputs(HP, 4, 5, "shared")
    geom = tk4.launch_geometry(4, HP, False, twins_per_block=4)
    with pytest.raises(ValueError, match="CUDA"):
        tk4.fused_analogue_rollout_at(geom, tst["gps"], tst["gms"],
                                      tst["scales"], t(y0), t(u), 0.01)


@pytest.mark.parametrize("change,match", [
    (dict(read_noise=0.02, g_min=0.0), "g_min > 0"),
    (dict(fault={"stuck_rate": 0.1}, g_max=0.0), "g_max > g_min"),
    (dict(fault={"cosmic_rays": 1.0}), "unknown fault keys"),
    (dict(scales_len=2), "per layer"),
    (dict(u_dtype=torch.int64), "non-floating"),
    (dict(y0_rows=3), "not divisible"),
    (dict(float_arrays=True), "uint8 level indices"),
    (dict(device="meta"), "meta"),
])
def test_argument_errors(change, match):
    _, tst = staged_arrays(HP, "uint8")
    y0, u = inputs(HP, 4, 5, "shared")
    y0, u = t(y0), t(u)
    kw = dict(g_step=tst["g_step"], g_min=G_MIN, g_max=G_MAX, batch_tile=2)
    gps, gms, scales = tst["gps"], tst["gms"], tst["scales"]
    for k in ("read_noise", "g_min", "g_max", "fault"):
        if k in change:
            kw[k] = change[k]
    if "scales_len" in change:
        scales = scales[:2]
    if "u_dtype" in change:
        u = u.to(change["u_dtype"])
    if "y0_rows" in change:
        y0 = y0[:3]
    if "float_arrays" in change:
        gps = [g.float() for g in gps]
    if "device" in change:
        y0, u, scales = (x.to("meta") for x in (y0, u, scales))
        gps = [g.to("meta") for g in gps]
        gms = [g.to("meta") for g in gms]
    with pytest.raises(ValueError, match=match):
        tk4.fused_analogue_rollout(gps, gms, scales, y0, u, 0.01, **kw)
