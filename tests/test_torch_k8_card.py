"""K8 at dv != d and MLA's flash branch on a CUDA card (these tests skip
without one; the file imports no JAX, so it runs on a card's machine).

The kernel at the compiled MLA pairs (48, 32) and (576, 512) against its
plain version (2e-5 of the peak in float32, 2e-2 in bf16, the JAX
package's kernel-test tolerances), V read as the first dv columns of K
as MLA hands them over; an uncompiled pair raising; and the smoke
DeepSeek config's ``mla_prefill`` through the absorbed flash branch on
the card (one K8 launch) against the same call on the CPU (the chunked
schedule), within 1e-4 of the peak.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import flash_attention as tk8  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def peak_err(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL), ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,hkv,s,d,dv", [(1, 4, 1, 97, 48, 32),
                                            (1, 16, 1, 300, 576, 512)])
def test_k8_kernel_at_dv_matches_plain_on_card(card, b, h, hkv, s, d, dv,
                                               dtype):
    rng = np.random.default_rng(s)
    q = torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(
        np.float32)).to(card, dtype)
    k = torch.from_numpy(rng.standard_normal((b, hkv, s, d)).astype(
        np.float32)).to(card, dtype)
    v = k[..., :dv]
    scale = (d // 3) ** -0.5
    before = tk8.LAUNCHES
    got = tops.flash_attention(q, k, v, scale=scale)
    want = tref.flash_attention_ref(q, k, v, scale=scale)
    assert tk8.LAUNCHES == before + 1
    assert got.shape == (b, h, s, dv) and got.dtype == dtype
    assert peak_err(got, want) <= TOL[dtype]


@pytest.mark.cuda
def test_uncompiled_pair_raises_on_card(card):
    q = torch.zeros((1, 2, 64, 96), device=card)
    with pytest.raises(ValueError, match="queue 2 A5"):
        tops.flash_attention(q, q, q[..., :64])


@pytest.mark.cuda
def test_mla_prefill_flash_branch_on_card(card):
    cfg = get_smoke("deepseek-v2-236b")
    acfg = dataclasses.replace(tmodel.attn_config(cfg), flash_threshold=32)
    params = tattn.mla_init(torch.Generator().manual_seed(0), acfg)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 128, acfg.d_model)).astype(np.float32))
    want, want_cache = tattn.mla_prefill(params, acfg, x, pos0=0)
    before = tk8.LAUNCHES
    got, cache = tattn.mla_prefill(
        {k: v.to(card) for k, v in params.items()}, acfg, x.to(card))
    assert tk8.LAUNCHES == before + 1
    assert peak_err(got, want) <= 1e-4
    for key in want_cache:
        assert peak_err(cache[key], want_cache[key]) <= 1e-5
