"""MLA (DeepSeek-V2) and the multi-part flash schedule against the JAX
package, on the CPU.

Held against JAX: K8's plain version at dv != d
(``ref.flash_attention_ref`` against ``flash_attention_pallas`` in
interpret mode), the port's ``models/flash.flash_attention`` (JAX's
chunked online-softmax schedule in torch) against
``repro.models.flash.flash_attention``, ``mla_prefill`` (dense and
absorbed flash branches) and ``mla_decode`` for both DeepSeek-V2 smoke
configs (direct q and q-LoRA), the MLA param trees carried across by
``interop.lm_params_from_numpy``, the DeepSeek block program, and the
whole model's prefill step and decode steps.  Attention params are
JAX-made and carried across, the whole model's are the port's seeded
init handed to JAX as numpy; inputs are made with numpy from a seed.

Tolerances, of the peak |ref|: K8's plain version 2e-5 (the JAX
package's own kernel test); the flash schedule 1e-5 (the same chunked
float32 arithmetic, sums in other orders); attention outputs 1e-4 and
caches 1e-5, the logits 1e-4, as the GQA tests hold.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.kernels.legacy.flash_attention import (  # noqa: E402
    flash_attention_pallas, flash_attention_pallas_ref)
from repro.models import attention as jattn  # noqa: E402
from repro.models import flash as jflash  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.train import lm_trainer as jtrainer  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.interop import (lm_params_from_numpy,  # noqa: E402
                                 lm_params_to_numpy)
from repro_torch.kernels import flash_attention as tk8  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import flash as tflash  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.train import lm_trainer as ttrainer  # noqa: E402

DEEPSEEK = ["deepseek-v2-lite-16b", "deepseek-v2-236b"]


def peak_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def t2n(t):
    return t.detach().to(torch.float32).cpu().numpy()


def port_cfg(jcfg):
    """The port's config of the same values as a JAX config."""
    mapping = {jbase.ArchConfig: tbase.ArchConfig,
               jmamba.MambaConfig: tmamba.MambaConfig,
               jmoe.MoEConfig: tmoe.MoEConfig,
               jattn.AttnConfig: tattn.AttnConfig}
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for k, v in kw.items():
        if type(v) in mapping:
            kw[k] = port_cfg(v)
    return mapping[type(jcfg)](**kw)


def smoke(name, **over):
    jcfg = dataclasses.replace(jconfigs.get_smoke(name), **over)
    return jcfg, port_cfg(jcfg)


def params_pair(tcfg):
    """The port's seeded params and the same values as JAX arrays (the
    trees are equal: ``test_init_params_tree_matches_jax``)."""
    tp = tmodel.init_params(tcfg, seed=0, device="cpu")
    return jax.tree_util.tree_map(jnp.asarray, lm_params_to_numpy(tp)), tp


def tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


# ---------------------------------------------------------------------------
# K8's plain version at dv != d
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,hkv,s,d,dv,bq", [
    (1, 4, 1, 64, 48, 32, 32),      # the smoke configs' absorbed MLA
    (2, 4, 2, 32, 32, 16, 16),      # GQA groups at dv < d
    (1, 2, 1, 32, 16, 64, 32),      # dv > d
], ids=["mla-smoke", "gqa", "wide-v"])
def test_flash_plain_matches_pallas_at_dv(b, h, hkv, s, d, dv, bq):
    rng = np.random.default_rng(s + d + dv)
    qn, kn = (rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, h, s, d), (b, hkv, s, d)))
    vn = rng.standard_normal((b, hkv, s, dv)).astype(np.float32)
    scale = (d + 8) ** -0.5           # a scale other than d ** -0.5
    want = flash_attention_pallas(jnp.asarray(qn), jnp.asarray(kn),
                                  jnp.asarray(vn), scale=scale, bq=bq, bk=bq)
    oracle = flash_attention_pallas_ref(jnp.asarray(qn), jnp.asarray(kn),
                                        jnp.asarray(vn), scale=scale)
    tq, tk, tv = (torch.from_numpy(x) for x in (qn, kn, vn))
    got = tref.flash_attention_ref(tq, tk, tv, scale=scale)
    assert got.shape == (b, h, s, dv) and got.dtype == torch.float32
    assert torch.equal(tops.flash_attention(tq, tk, tv, scale=scale), got)
    for w in (want, oracle):
        assert peak_err(t2n(got), w) <= 2e-5


def test_kernel_pairs_and_refusals():
    """The compiled (d, dv) pairs; any other raises on the card, naming
    ROADMAP queue 2 A5 (the CPU takes the plain version for every pair);
    bf16 score tiles raise on every device; the card path refuses unequal
    lengths or offsets and mixed kv head counts before it launches."""
    assert set(tk8.PAIRS) == {(16, 16), (32, 32), (64, 64), (128, 128),
                              (48, 32), (576, 512)}
    for pair in tk8.PAIRS:
        tk8.check_pair(*pair)
    for pair in ((96, 64), (576, 576), (512, 512), (48, 48)):
        with pytest.raises(ValueError, match="queue 2 A5"):
            tk8.check_pair(*pair)
    q = torch.zeros((1, 64, 2, 16))
    with pytest.raises(NotImplementedError, match="score"):
        tflash.flash_attention([q], [q], q, scale=0.25,
                               score_dtype="bfloat16")
    with pytest.raises(ValueError, match="not divisible by the flash"):
        tflash.flash_attention([q], [q], q, scale=0.25, q_chunk=48)
    with pytest.raises(NotImplementedError, match="equal"):
        tflash._on_card([q[:, :32]], [q], q, 0.25, 32, 0)
    with pytest.raises(NotImplementedError, match="equal"):
        tflash._on_card([q], [q], q, 0.25, 3, 0)
    with pytest.raises(NotImplementedError, match="kv head"):
        tflash._on_card([q, q], [q, q[:, :, :1]], q, 0.25, 0, 0)
    jcfg, tcfg = smoke("deepseek-v2-lite-16b")
    tac = dataclasses.replace(tmodel.attn_config(tcfg), flash_threshold=32,
                              score_dtype="bfloat16")
    tp = tattn.mla_init(torch.Generator().manual_seed(0), tac)
    with pytest.raises(NotImplementedError, match="score"):
        tattn.mla_prefill(tp, tac, torch.zeros((1, 64, tac.d_model)))


# ---------------------------------------------------------------------------
# the multi-part flash schedule (models/flash.py)
# ---------------------------------------------------------------------------

def flash_case(seed, b, sq, skv, h, hkv, dims, dv):
    rng = np.random.default_rng(seed)
    qs = [rng.standard_normal((b, sq, h, d)).astype(np.float32)
          for d in dims]
    ks = [rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
          for d in dims]
    v = rng.standard_normal((b, skv, hkv, dv)).astype(np.float32)
    return qs, ks, v


def flash_pair(qs, ks, v, **kw):
    want = jflash.flash_attention([jnp.asarray(x) for x in qs],
                                  [jnp.asarray(x) for x in ks],
                                  jnp.asarray(v), **kw)
    got = tflash.flash_attention([torch.from_numpy(x) for x in qs],
                                 [torch.from_numpy(x) for x in ks],
                                 torch.from_numpy(v), **kw)
    return got, want


@pytest.mark.parametrize("dims,hkv,pos0,causal_skip", [
    ((32,), 2, 0, False), ((32,), 1, 3, True), ((24, 8), 1, 0, True),
    ((24, 8), 1, 3, False), ((24, 8), 2, 3, True), ((24, 8), 2, 0, False)],
    ids=["one-gqa-0-full", "one-mqa-3-skip", "two-mqa-0-skip",
         "two-mqa-3-full", "two-gqa-3-skip", "two-gqa-0-full"])
def test_flash_schedule_matches_jax(dims, hkv, pos0, causal_skip):
    """One or two score parts, dv != d, Hkv 1 and 2, equal offsets 0 and 3,
    causal_skip on and off (each against each other setting at least
    once), 4 q chunks x 4 kv chunks of 16."""
    qs, ks, v = flash_case(sum(dims) + hkv + pos0, 2, 64, 64, 4, hkv, dims,
                           20)
    got, want = flash_pair(qs, ks, v, scale=sum(dims) ** -0.5, q_pos0=pos0,
                           kv_pos0=pos0, q_chunk=16, kv_chunk=16,
                           causal_skip=causal_skip)
    assert got.shape == (2, 64, 4, 20) and got.dtype == torch.float32
    assert peak_err(t2n(got), want) <= 1e-5


@pytest.mark.parametrize("causal_skip", [False, True], ids=["full", "skip"])
def test_flash_schedule_unequal_offsets_match_jax(causal_skip):
    """A chunk of 32 queries at positions 32..63 against 64 keys from 0
    (a chunked prefill), q chunks of 8 and kv chunks of 16."""
    qs, ks, v = flash_case(7, 1, 32, 64, 4, 1, (24, 8), 16)
    got, want = flash_pair(qs, ks, v, scale=0.2, q_pos0=32, kv_pos0=0,
                           q_chunk=8, kv_chunk=16, causal_skip=causal_skip)
    assert peak_err(t2n(got), want) <= 1e-5


def test_flash_schedule_dynamic_band_matches_jax():
    """More than 32 q chunks: JAX's dynamic banded loop."""
    qs, ks, v = flash_case(9, 1, 68, 68, 2, 1, (8, 8), 8)
    got, want = flash_pair(qs, ks, v, scale=0.25, q_pos0=0, kv_pos0=0,
                           q_chunk=2, kv_chunk=4, causal_skip=True)
    assert peak_err(t2n(got), want) <= 1e-5


# ---------------------------------------------------------------------------
# MLA attention
# ---------------------------------------------------------------------------

def mla_case(name, **over):
    jcfg, _ = smoke(name)
    jac = dataclasses.replace(jmodel.attn_config(jcfg), **over)
    tac = port_cfg(jac)
    jp = jattn.mla_init(jax.random.PRNGKey(5), jac)
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jac, tac, jp, tp


@pytest.mark.parametrize("branch", ["dense", "flash"])
@pytest.mark.parametrize("name", DEEPSEEK)
def test_mla_prefill_matches_jax(name, branch):
    over = {"flash_threshold": 32, "q_chunk": 16, "kv_chunk": 32} \
        if branch == "flash" else {}
    jac, tac, jp, tp = mla_case(name, **over)
    x = np.random.default_rng(6).standard_normal(
        (2, 64, jac.d_model)).astype(np.float32)
    jo, jc = jattn.mla_prefill(jp, jac, jnp.asarray(x), pos0=3)
    to, tc = tattn.mla_prefill(tp, tac, torch.from_numpy(x), pos0=3)
    assert peak_err(t2n(to), jo) <= 1e-4
    assert set(tc) == {"ckv", "k_rope"}
    for key in tc:
        assert tc[key].shape == jc[key].shape
        assert peak_err(t2n(tc[key]), jc[key]) <= 1e-5


@pytest.mark.parametrize("name", DEEPSEEK)
def test_mla_decode_matches_jax(name):
    jac, tac, jp, tp = mla_case(name)
    b, smax = 2, 12
    jcache = {"ckv": jnp.zeros((b, smax, jac.kv_lora)),
              "k_rope": jnp.zeros((b, smax, jac.rope_dim))}
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    rng = np.random.default_rng(7)
    for pos in range(5):
        x = rng.standard_normal((b, 1, jac.d_model)).astype(np.float32)
        jo, jcache = jattn.mla_decode(jp, jac, jnp.asarray(x),
                                      jnp.asarray(pos, jnp.int32), jcache)
        to, tcache = tattn.mla_decode(tp, tac, torch.from_numpy(x), pos,
                                      tcache)
        assert peak_err(t2n(to), jo) <= 1e-4
    for key in jcache:
        assert peak_err(t2n(tcache[key]), jcache[key]) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", DEEPSEEK)
def test_mla_params_carried_from_jax(name, dtype):
    """``lm_params_from_numpy`` carries JAX's MLA trees (``wq`` or
    ``w_dq``/``w_uq``, ``w_dkv``, ``w_uk``, ``w_uv``, ``w_kr``, ``wo``):
    the same keys, values and dtypes, bf16 included, and back."""
    jac, _, _, _ = mla_case(name)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = jattn.mla_init(jax.random.PRNGKey(8), jac, jdt)
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    want_keys = {"w_dkv", "w_uk", "w_uv", "w_kr", "wo"} | (
        {"w_dq", "w_uq"} if jac.q_lora else {"wq"})
    assert set(jp) == set(tp) == want_keys
    back = lm_params_to_numpy(tp)
    for key in jp:
        assert str(tp[key].dtype) == f"torch.{dtype}"
        assert tuple(tp[key].shape) == jp[key].shape
        np.testing.assert_array_equal(back[key],
                                      np.asarray(jp[key], np.float32))
    # the port's own init draws the same tree
    own = tattn.mla_init(torch.Generator().manual_seed(0), port_cfg(jac),
                         getattr(torch, dtype))
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in tp.items()}


# ---------------------------------------------------------------------------
# the DeepSeek models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", DEEPSEEK)
def test_deepseek_block_program_matches_jax(name):
    """One dense prelude block at ``d_ff_dense``, then MoE periods
    (shared + routed experts, top-k)."""
    jcfg, tcfg = smoke(name)
    for cfg_j, cfg_t in ((jcfg, tcfg), (jconfigs.get_config(name),
                                        port_cfg(jconfigs.get_config(name)))):
        jpre, jper, jn = jmodel.block_program(cfg_j)
        tpre, tper, tn = tmodel.block_program(cfg_t)
        assert [(s.mixer, s.ffn) for s in tpre] == \
            [(s.mixer, s.ffn) for s in jpre]
        assert [(s.mixer, s.ffn) for s in tper] == \
            [(s.mixer, s.ffn) for s in jper]
        assert tn == jn
    full = jconfigs.get_config(name)
    assert (full.first_k_dense, full.moe.n_shared, full.moe.top_k) == \
        (1, 2, 6)


@pytest.mark.parametrize("name", DEEPSEEK)
def test_deepseek_prefill_and_decode_match_jax(name):
    """The prefill step through the absorbed flash branch (S = 64 >
    flash_threshold 32), then 4 decode steps from empty caches."""
    jcfg, tcfg = smoke(name, flash_threshold=32)
    jp, tp = params_pair(tcfg)
    batch = tokens(21, (2, 65), jcfg.vocab)
    jl, jc = jtrainer.make_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(
        batch)})
    tl, tc = ttrainer.make_prefill_step(tcfg)(tp, {
        "tokens": torch.from_numpy(batch).long()})
    assert tl.dtype == torch.float32 and tl.shape == (2, jcfg.vocab)
    assert peak_err(t2n(tl), jl) <= 1e-4
    jleaves = jax.tree_util.tree_leaves(jc)
    tleaves = jax.tree_util.tree_leaves(lm_params_to_numpy(tc))
    assert len(jleaves) == len(tleaves) == 4    # ckv, k_rope: prelude, stack
    for jv, tv in zip(jleaves, tleaves):
        assert jv.shape == tv.shape
        assert peak_err(tv, jv) <= 1e-5
    jcache = jmodel.init_cache(jcfg, 2, 8)
    tcache = tmodel.init_cache(tcfg, 2, 8, device="cpu")
    for leaf_j, leaf_t in zip(jax.tree_util.tree_leaves(jcache),
                              jax.tree_util.tree_leaves(tcache)):
        assert tuple(leaf_j.shape) == tuple(leaf_t.shape)
    serve = ttrainer.make_serve_step(tcfg)
    jstep = jax.jit(lambda p, t, pos, c: jmodel.decode_step(p, jcfg, t, pos,
                                                             c))
    for i in range(4):
        tok = batch[:, i:i + 1]
        jl, jcache = jstep(jp, jnp.asarray(tok), jnp.asarray(i, jnp.int32),
                           jcache)
        tl, tcache = serve(tp, {"tokens": torch.from_numpy(tok).long()}, i,
                           tcache)
        assert peak_err(t2n(tl), jl[:, -1]) <= 1e-4
