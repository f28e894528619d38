"""The plain versions of the port's LM kernels against the JAX package, on
the CPU: K8 (causal GQA flash attention) and K9 (the selective-SSM scan).

``ref.flash_attention_ref`` / ``ops.flash_attention`` and
``ref.ssm_scan_ref`` / ``ops.ssm_scan`` (which take the plain versions
for CPU tensors) are held against the Pallas kernels, run in interpret
mode as ``tests/test_legacy_kernels.py`` runs them, against their jnp
oracles, and K8 also against the XLA flash schedule the JAX models use.
The same numpy-made arrays go through both packages.

Tolerances are those of the JAX package's own tests, of the peak |ref|:
K8 2e-5 in float32 and 2e-2 in bfloat16 (the output is rounded to bf16),
K9 1e-5.  The tests marked ``cuda`` hold the kernels against the plain
versions on a card and skip without one; there the bf16 K8 output is also
held, per element, to bf16's rounding bound 2^-8 |want| (plus 2e-5 of the
peak) against the plain version's float32 output before its cast.  The
bf16 kernel's rounding scheme (float32 scores and softmax, P split into
bf16 hi + lo for P.V) is emulated in plain torch and held to that bound
here, and P rounded to bf16 alone shown to miss it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.legacy.flash_attention import (  # noqa: E402
    flash_attention_pallas, flash_attention_pallas_ref)
from repro.kernels.legacy.ssm_scan import ssm_scan, ssm_scan_ref  # noqa: E402
from repro.models.flash import flash_attention as xla_flash  # noqa: E402
from repro_torch.kernels import flash_attention as tk8  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssm_scan as tk9  # noqa: E402

# (B, H, Hkv, S, d, bq, bk) and (B, S, DI, N, d_tile) of
# tests/test_legacy_kernels.py
FLASH_SHAPES = [(1, 2, 2, 32, 16, 16, 16), (2, 4, 2, 64, 32, 32, 16),
                (1, 8, 2, 128, 64, 64, 64)]
SCAN_SHAPES = [(1, 8, 16, 4, 16), (2, 32, 64, 16, 32), (1, 64, 128, 16, 128)]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def peak_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def flash_inputs(seed, b, h, hkv, s, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))]


def scan_inputs(seed, bsz, s, di, n):
    """Drawn as the JAX test draws them: dt = softplus(N) * 0.1, B, C, x
    normal, A = -exp(0.3 N)."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, s, di)))) * 0.1
    b = rng.standard_normal((bsz, s, n))
    c = rng.standard_normal((bsz, s, n))
    x = rng.standard_normal((bsz, s, di))
    a = -np.exp(rng.standard_normal((di, n)) * 0.3)
    return [v.astype(np.float32) for v in (dt, b, c, x, a)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,h,hkv,s,d,bq,bk", FLASH_SHAPES)
def test_flash_plain_matches_pallas_and_oracle(b, h, hkv, s, d, bq, bk,
                                               dtype):
    jdt, tdt, tol = DTYPES[dtype]
    qn, kn, vn = flash_inputs(s + h, b, h, hkv, s, d)
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (qn, kn, vn))
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (qn, kn, vn))
    pallas = flash_attention_pallas(jq, jk, jv, bq=bq, bk=bk)
    oracle = flash_attention_pallas_ref(jq, jk, jv)
    plain = tref.flash_attention_ref(tq, tk, tv)
    wrapped = tops.flash_attention(tq, tk, tv)
    assert plain.dtype == tdt and plain.shape == (b, h, s, d)
    assert torch.equal(wrapped, plain)      # the CPU path is the plain one
    for want in (pallas, oracle):
        assert peak_err(to_np(plain), np.asarray(want, np.float32)) <= tol


def test_flash_plain_matches_model_flash_schedule():
    """Against ``models/flash.flash_attention``, the XLA schedule of
    ``gqa_prefill``'s flash branch, at chunks of 16 (2e-5)."""
    b, h, hkv, s, d = 1, 4, 2, 64, 32
    rng = np.random.default_rng(0)
    qn = rng.standard_normal((b, s, h, d)).astype(np.float32)
    kn = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    vn = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    want = xla_flash([jnp.asarray(qn)], [jnp.asarray(kn)], jnp.asarray(vn),
                     scale=d ** -0.5, q_chunk=16, kv_chunk=16)
    tq, tk, tv = (torch.from_numpy(x).transpose(1, 2) for x in (qn, kn, vn))
    got = tops.flash_attention(tq, tk, tv, scale=d ** -0.5).transpose(1, 2)
    assert peak_err(to_np(got), np.asarray(want)) <= 2e-5


def test_flash_wrapper_checks_and_traffic():
    q = torch.zeros((1, 4, 8, 16))
    with pytest.raises(ValueError, match="Hkv dividing H"):
        tops.flash_attention(q, torch.zeros((1, 3, 8, 16)),
                             torch.zeros((1, 3, 8, 16)))
    with pytest.raises(ValueError, match="dv"):
        tops.flash_attention(q, torch.zeros((1, 2, 8, 16)),
                             torch.zeros((1, 2, 7, 8)))
    # v of its own width dv: (B, H, S, dv) out
    assert tops.flash_attention(q, torch.zeros((1, 2, 8, 16)),
                                torch.zeros((1, 2, 8, 8))).shape == \
        (1, 4, 8, 8)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tops.flash_attention(q.double(), q.double(), q.double())
    from repro.kernels.legacy.flash_attention import hbm_traffic_bytes
    assert tk8.hbm_traffic_bytes(2, 32, 8, 4096, 128, 128) == \
        hbm_traffic_bytes(2, 32, 8, 4096, 128, 128)
    # at dv != d, V is counted at its own width (JAX's contract counts d)
    assert tk8.hbm_traffic_bytes(2, 16, 1, 4096, 576, 512)["kv"] == \
        2 * 4096 * (576 + 512) * 2


@pytest.mark.parametrize("bsz,s,di,n,d_tile", SCAN_SHAPES)
def test_ssm_scan_plain_matches_pallas_and_oracle(bsz, s, di, n, d_tile):
    arrays = scan_inputs(di + s, bsz, s, di, n)
    jargs = [jnp.asarray(x) for x in arrays]
    targs = [torch.from_numpy(x) for x in arrays]
    yk, hk = ssm_scan(*jargs, d_tile=d_tile)
    yr, hr = ssm_scan_ref(*jargs)
    y, h = tref.ssm_scan_ref(*targs)
    yw, hw = tops.ssm_scan(*targs)
    assert torch.equal(yw, y) and torch.equal(hw, h)
    assert y.shape == (bsz, s, di) and h.shape == (bsz, di, n)
    for want_y, want_h in ((yk, hk), (yr, hr)):
        assert peak_err(to_np(y), want_y) <= 1e-5
        assert peak_err(to_np(h), want_h) <= 1e-5


def test_ssm_scan_wrapper_checks():
    dt = torch.zeros((1, 4, 8))
    b = torch.zeros((1, 4, 2))
    a = torch.zeros((8, 2))
    with pytest.raises(ValueError, match="shape"):
        tops.ssm_scan(dt, b, b, dt, torch.zeros((8, 3)))
    with pytest.raises(ValueError, match="float32"):
        tops.ssm_scan(dt.double(), b, b, dt, a)
    with pytest.raises(ValueError, match="contiguous"):
        tops.ssm_scan(dt, b, b, torch.zeros((1, 8, 4)).transpose(1, 2), a)


# -- the bf16 tensor-core K8's rounding scheme, emulated on the CPU ------------

#: (B, H, Hkv, S, d) of the emulation: the JAX package's three test shapes,
#: a ragged S (not a multiple of 64), and a long one at the Jamba head dim.
MMA_SHAPES = [shape[:5] for shape in FLASH_SHAPES] + [(1, 4, 2, 97, 32),
                                                     (1, 4, 2, 1024, 128)]


def k8_mma_emulation(q, k, v, *, split_p=True, bk=64, scale=None):
    """What ``csrc/flash_attention.cu``'s bf16 kernels compute, in plain
    torch: bf16 inputs, float32 scores per ``bk``-key tile (64; 32 in the
    (576, 512) kernel; bf16 x bf16 products are exact in float32), the
    online softmax in float32 and in base 2 (scores times scale * log2(e),
    causal mask -1e30, exp2), P split into bf16 hi + lo for the P.V
    product (or, with ``split_p=False``, P rounded to bf16 alone), the
    output divided by max(l, 1e-30) and rounded to bf16."""
    b, h, s, d = q.shape
    group = h // k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    scale_log2 = float(torch.tensor(scale) * torch.tensor(1.4426950408889634))
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros((b, h, s, 1))
    o = torch.zeros((b, h, s, v.shape[-1]))
    rows = torch.arange(s)[:, None]
    for k0 in range(0, s, bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        sc = (qf @ kt.transpose(-1, -2)) * scale_log2
        sc = sc.masked_fill(torch.arange(k0, k0 + kt.shape[2])[None, :]
                            > rows, -1e30)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(sc - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        pv = hi @ vt
        if split_p:
            pv = pv + (p - hi).to(torch.bfloat16).float() @ vt
        o = o * corr + pv
        m = m_new
    return (o / l.clamp_min(1e-30)).to(torch.bfloat16)


def bf16_rounding_ratio(got, q, k, v, scale=None) -> float:
    """max |got - want| / (2^-8 |want| + 2e-5 of the peak), want the plain
    float32 output on the same (bf16-valued) inputs: the per-element bound
    ``chip_smoke.py`` holds the bf16 kernel to."""
    want = tref.flash_attention_ref(q.float(), k.float(), v.float(),
                                    scale=scale)
    limit = 2.0 ** -8 * want.abs() + 2e-5 * want.abs().max()
    return float(((got.float() - want).abs() / limit).max())


@pytest.mark.parametrize("b,h,hkv,s,d", MMA_SHAPES)
def test_k8_mma_scheme_meets_the_bf16_rounding_bound(b, h, hkv, s, d):
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in flash_inputs(s + d, b, h, hkv, s, d))
    got = k8_mma_emulation(q, k, v)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert bf16_rounding_ratio(got, q, k, v) <= 1.0


@pytest.mark.parametrize("b,h,hkv,s,d,dv,bk", [
    (1, 4, 1, 97, 48, 32, 64),        # the smoke configs' MLA, 64-key tiles
    (1, 16, 1, 640, 576, 512, 32),    # DeepSeek-V2's MLA kernel, 32-key tiles
], ids=["48-32", "576-512"])
def test_k8_mla_scheme_meets_the_bf16_rounding_bound(b, h, hkv, s, d, dv, bk):
    """The same scheme at MLA's (d, dv) pairs and its scale (kv_lora +
    rope scored, (head_dim + rope_dim) ** -0.5), K = [ckv, k_rope] and
    V = ckv as the model hands them over."""
    rng = np.random.default_rng(s + d)
    q = torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(
        np.float32)).to(torch.bfloat16)
    k = torch.from_numpy(rng.standard_normal((b, hkv, s, d)).astype(
        np.float32)).to(torch.bfloat16)
    v = k[..., :dv]
    scale = (d // 3) ** -0.5
    got = k8_mma_emulation(q, k, v, bk=bk, scale=scale)
    assert got.shape == (b, h, s, dv) and got.dtype == torch.bfloat16
    assert bf16_rounding_ratio(got, q, k, v, scale=scale) <= 1.0


def test_k8_bf16_p_alone_breaks_the_bound():
    """Why the kernel splits P: rounded to bf16 alone, P.V misses the
    per-element bound at the long shape."""
    b, h, hkv, s, d = MMA_SHAPES[-1]
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in flash_inputs(s + d, b, h, hkv, s, d))
    assert bf16_rounding_ratio(k8_mma_emulation(q, k, v, split_p=False),
                               q, k, v) > 1.0


def test_k8_bf16_alignment_rule():
    """The bf16 kernel's 16-byte copies read a tensor in place only where
    its address and (batch, head, row) strides are multiples of 16 bytes;
    the wrapper copies any other."""
    x = torch.zeros((2, 4, 8, 16), dtype=torch.bfloat16)
    assert tk8._aligned16(x) and tk8._aligned16(x.transpose(1, 2))
    assert not tk8._aligned16(torch.zeros(2 * 4 * 8 * 16 + 1,
                                          dtype=torch.bfloat16)[1:]
                              .view(2, 4, 8, 16))
    assert not tk8._aligned16(torch.zeros((2, 4, 8, 20),
                                          dtype=torch.bfloat16)[..., :16])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,h,hkv,s,d,bq,bk", FLASH_SHAPES)
def test_k8_kernel_matches_plain_on_card(card, b, h, hkv, s, d, bq, bk,
                                         dtype):
    _, tdt, tol = DTYPES[dtype]
    q, k, v = (torch.from_numpy(x).to(card, tdt)
               for x in flash_inputs(s + h, b, h, hkv, s, d))
    before = tk8.LAUNCHES
    got = tops.flash_attention(q, k, v)
    again = tops.flash_attention(q, k, v)
    want = tref.flash_attention_ref(q, k, v)
    assert tk8.LAUNCHES == before + 2
    assert torch.equal(got, again)
    assert peak_err(to_np(got), to_np(want)) <= tol
    if tdt == torch.bfloat16:
        want32 = tref.flash_attention_ref(q.float(), k.float(), v.float())
        atol = DTYPES["float32"][2] * want32.abs().max()
        assert ((got.float() - want32).abs()
                <= 2.0 ** -8 * want32.abs() + atol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,s,di,n,d_tile", SCAN_SHAPES)
def test_k9_kernel_matches_plain_on_card(card, bsz, s, di, n, d_tile):
    args = [torch.from_numpy(x).to(card)
            for x in scan_inputs(di + s, bsz, s, di, n)]
    before = tk9.LAUNCHES
    y, h = tops.ssm_scan(*args)
    y2, h2 = tops.ssm_scan(*args)
    yr, hr = tref.ssm_scan_ref(*args)
    assert tk9.LAUNCHES == before + 2
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert peak_err(to_np(y), to_np(yr)) <= 1e-5
    assert peak_err(to_np(h), to_np(hr)) <= 1e-5
