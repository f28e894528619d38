"""The port's LM serving slice against the JAX package, on the CPU.

Layers, MoE, Mamba, GQA attention, the whole model (forward, decode,
greedy generation, the prefill step) and the configs' parameter counts
are held against the JAX package.  Params are made by JAX's
``init_params`` and carried across with ``interop.lm_params_from_numpy``;
inputs are made with numpy from a seed; the same arrays go through both
packages.  Where the JAX model reaches the flash schedule or the chunked
scan, the port runs the plain versions of K8 and K9 (the CPU path).

Tolerances are of the peak |ref|: elementwise layers 1e-6; the MoE 1e-5
(aux 1e-6) with equal expert choices and drop masks; Mamba prefill 1e-4
(sequential scan against JAX's chunked associative scan, the JAX
package's own kernel-vs-model tolerance), decode 1e-5; attention and
the forward 1e-4 (aux 1e-5): float32 sums in other orders.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.data import tokens as jtokens  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.train import lm_trainer as jtrainer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.data import tokens as ttokens  # noqa: E402
from repro_torch.interop import (lm_params_from_numpy,  # noqa: E402
                                 lm_params_to_numpy)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.train import lm_trainer as ttrainer  # noqa: E402

DENSE = ["llama3-8b", "qwen3-1.7b", "internlm2-20b", "qwen1.5-32b",
         "musicgen-medium", "chameleon-34b"]
DEEPSEEK = ["deepseek-v2-lite-16b", "deepseek-v2-236b"]
XLSTM = ["xlstm-125m"]
PORTED = ["jamba-v0.1-52b", *DENSE, *DEEPSEEK, *XLSTM]


def peak_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def t2n(t):
    return t.detach().to(torch.float32).cpu().numpy()


def port_cfg(jcfg):
    """The port's config of the same values as a JAX ArchConfig (or any of
    its sub-configs)."""
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


_PARAMS = {}


def params_pair(jcfg):
    """JAX-made params (key 0, drawn under ``jax.jit``: the eager draw of
    a smoke model's tree takes ~15 s here) and the same values as
    tensors."""
    key = jcfg
    if key not in _PARAMS:
        jp = jax.jit(jmodel.init_params, static_argnums=0)(
            jcfg, jax.random.PRNGKey(0))
        _PARAMS[key] = (jp, lm_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp), "cpu"))
    return _PARAMS[key]


def tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_norms_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    pos = np.arange(3, 11)[None, :].repeat(2, 0).astype(np.int32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    cases = [
        (jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jx),
         tlayers.rmsnorm({"scale": torch.from_numpy(scale)}, tx)),
        (jlayers.layernorm({"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)}, jx),
         tlayers.layernorm({"scale": torch.from_numpy(scale),
                            "bias": torch.from_numpy(bias)}, tx)),
        (jlayers.head_rmsnorm(jnp.asarray(scale), jx),
         tlayers.head_rmsnorm(torch.from_numpy(scale), tx)),
        (jlayers.apply_rope(jx, jnp.asarray(pos), 500000.0),
         tlayers.apply_rope(tx, torch.from_numpy(pos), 500000.0)),
    ]
    for want, got in cases:
        assert peak_err(t2n(got), want) <= 1e-6
    # bf16 in, bf16 out, computed in float32
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert tlayers.rmsnorm({"scale": torch.ones(16)}, xb).dtype == \
        torch.bfloat16


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu", "relu"])
def test_mlp_matches_jax(mlp_type):
    jp = jlayers.mlp_init(jax.random.PRNGKey(1), 32, 48, mlp_type)
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    x = np.random.default_rng(1).standard_normal((2, 5, 32)).astype(
        np.float32)
    want = jlayers.mlp_apply(jp, jnp.asarray(x), mlp_type)
    got = tlayers.mlp_apply(tp, torch.from_numpy(x), mlp_type)
    assert peak_err(t2n(got), want) <= 1e-6
    assert tlayers.mlp_flops(32, 48, mlp_type) == \
        jlayers.mlp_flops(32, 48, mlp_type)


def test_unembed_is_float32_from_bf16():
    x = torch.randn((1, 3, 8)).to(torch.bfloat16)
    table = torch.randn((5, 8)).to(torch.bfloat16)
    got = tlayers.unembed(x, table)
    assert got.dtype == torch.float32
    want = x.double() @ table.double().t()
    assert torch.allclose(got.double(), want, atol=1e-6)


@pytest.mark.cuda
def test_unembed_card_branch_matches_widened_product():
    """bf16 operands on the card take cuBLAS with a float32 output; held
    against the product of the widened operands (1e-4 of the peak, where a
    bf16-rounded output would be ~2^-9 of it off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the float32-output bf16 product "
                    "runs only there")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 64, 512)).astype(
        np.float32)).to("cuda", torch.bfloat16)
    table = torch.from_numpy((rng.standard_normal((1000, 512)) / 32).astype(
        np.float32)).to("cuda", torch.bfloat16)
    got = tlayers.unembed(x, table)
    assert got.dtype == torch.float32 and got.shape == (2, 64, 1000)
    want = x.float() @ table.float().t()
    assert peak_err(t2n(got), t2n(want)) <= 1e-4


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def jax_dispatch(idx, s, k, e, c):
    """The JAX module's per-group dispatch (sorted expert, token, valid)."""
    def one(idx_g):
        e_flat = idx_g.reshape(-1)
        tok = jnp.repeat(jnp.arange(s), k)
        order = jnp.argsort(e_flat)
        se, st = e_flat[order], tok[order]
        starts = jnp.searchsorted(se, jnp.arange(e))
        pos = jnp.arange(s * k) - starts[se]
        return se, st, pos < c
    return jax.vmap(one)(idx)


@pytest.mark.parametrize("name,cf", [("jamba-v0.1-52b", None),
                                     ("deepseek-v2-lite-16b", None),
                                     ("jamba-v0.1-52b", 0.5)],
                         ids=["jamba", "deepseek", "jamba-dropping"])
def test_moe_matches_jax(name, cf):
    jm = jconfigs.get_smoke(name).moe
    if cf is not None:
        jm = dataclasses.replace(jm, capacity_factor=cf)
    tm = port_cfg(jm)
    d, b, s = 64, 2, 24
    jp = jmoe.moe_init(jax.random.PRNGKey(2), jm, d)
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    x = np.random.default_rng(2).standard_normal((b, s, d)).astype(
        np.float32)
    jy, jaux = jmoe.moe_apply(jp, jm, jnp.asarray(x))
    ty, taux = tmoe.moe_apply(tp, tm, torch.from_numpy(x))
    # expert choices and drop masks
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    _, jidx = jax.lax.top_k(probs, jm.top_k)
    _, _, tidx = tmoe.route(tp, tm, torch.from_numpy(x))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    c = tmoe.capacity(s, tm)
    assert c == jmoe.capacity(s, jm)
    se, st, valid = jax_dispatch(jidx, s, jm.top_k, jm.n_experts, c)
    e_flat = tidx.reshape(b, -1)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    np.testing.assert_array_equal(
        torch.gather(e_flat, 1, order).numpy(), np.asarray(se))
    t_se = torch.gather(e_flat, 1, order)
    starts = torch.searchsorted(t_se, torch.arange(jm.n_experts).expand(
        b, -1).contiguous())
    t_valid = (torch.arange(s * jm.top_k) - torch.gather(starts, 1, t_se)) < c
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(valid))
    if cf is not None:
        assert not bool(np.asarray(valid).all())     # some pairs drop
    assert peak_err(t2n(ty), jy) <= 1e-5
    assert abs(float(taux) - float(jaux)) <= 1e-6 * max(1.0, abs(float(jaux)))


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

def test_mamba_prefill_and_decode_match_jax():
    jc = jconfigs.get_smoke("jamba-v0.1-52b").mamba
    tc = port_cfg(jc)
    jp = jmamba.mamba_init(jax.random.PRNGKey(3), jc)
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    u = np.random.default_rng(3).standard_normal((2, 64, 64)).astype(
        np.float32)
    jy, js = jmamba.mamba_prefill(jp, jc, jnp.asarray(u))
    ty, ts = tmamba.mamba_prefill(tp, tc, torch.from_numpy(u))
    assert peak_err(t2n(ty), jy) <= 1e-4
    assert peak_err(t2n(ts["ssm"]), js["ssm"]) <= 1e-4
    assert peak_err(t2n(ts["conv"]), js["conv"]) <= 1e-4
    # one decode step from JAX's state, same inputs
    u1 = np.random.default_rng(4).standard_normal((2, 1, 64)).astype(
        np.float32)
    jy1, js1 = jmamba.mamba_decode(jp, jc, jnp.asarray(u1), js)
    ty1, ts1 = tmamba.mamba_decode(
        tp, tc, torch.from_numpy(u1),
        {k: torch.from_numpy(np.array(v)) for k, v in js.items()})
    assert peak_err(t2n(ty1), jy1) <= 1e-5
    assert peak_err(t2n(ts1["ssm"]), js1["ssm"]) <= 1e-5
    assert peak_err(t2n(ts1["conv"]), js1["conv"]) <= 1e-5


def test_mamba_prefill_keeps_jax_checks():
    tc = port_cfg(jconfigs.get_smoke("jamba-v0.1-52b").mamba)
    tp = tmamba.mamba_init(torch.Generator().manual_seed(0), tc)
    assert tp["dt_bias"].dtype == tp["A_log"].dtype == torch.float32
    with pytest.raises(ValueError, match="not divisible by mamba chunk"):
        tmamba.mamba_prefill(tp, tc, torch.zeros((1, 24, 64)))
    with pytest.raises(NotImplementedError, match="float32"):
        tmamba.mamba_prefill(tp, dataclasses.replace(
            tc, scan_dtype="bfloat16"), torch.zeros((1, 16, 64)))


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def attn_case(name, **over):
    jcfg, _ = smoke(name)
    jac = dataclasses.replace(jmodel.attn_config(jcfg), **over)
    tac = port_cfg(jac)
    jp = jattn.gqa_init(jax.random.PRNGKey(5), jac)
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jac, tac, jp, tp


@pytest.mark.parametrize("branch", ["dense", "flash"])
@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "qwen3-1.7b",
                                  "qwen1.5-32b"])
def test_gqa_prefill_matches_jax(name, branch):
    over = {"flash_threshold": 32} if branch == "flash" else {}
    jac, tac, jp, tp = attn_case(name, **over)
    x = np.random.default_rng(6).standard_normal(
        (2, 64, jac.d_model)).astype(np.float32)
    jo, jc = jattn.gqa_prefill(jp, jac, jnp.asarray(x), pos0=3)
    to, tc = tattn.gqa_prefill(tp, tac, torch.from_numpy(x), pos0=3)
    assert peak_err(t2n(to), jo) <= 1e-4
    assert peak_err(t2n(tc["k"]), jc["k"]) <= 1e-5
    assert peak_err(t2n(tc["v"]), jc["v"]) <= 1e-5


def test_gqa_prefill_flash_branch_checks():
    _, tac, _, tp = attn_case("jamba-v0.1-52b", flash_threshold=32,
                              q_chunk=48)
    with pytest.raises(ValueError, match="not divisible by the flash"):
        tattn.gqa_prefill(tp, tac, torch.zeros((1, 64, 64)))
    with pytest.raises(NotImplementedError, match="score.*queue 1 item 13"):
        tattn.gqa_prefill(tp, dataclasses.replace(
            tac, q_chunk=32, score_dtype="bfloat16"),
            torch.zeros((1, 64, 64)))


@pytest.mark.parametrize("quant", [False, True], ids=["bf", "int8"])
def test_gqa_decode_matches_jax(quant):
    jac, tac, jp, tp = attn_case("llama3-8b", kv_cache_quant=quant)
    b, smax, hd = 2, 12, jac.head_dim
    shape = (b, smax, jac.n_kv, hd)
    if quant:
        jcache = {"k": jnp.zeros(shape, jnp.int8),
                  "v": jnp.zeros(shape, jnp.int8),
                  "k_scale": jnp.zeros(shape[:3] + (1,), jnp.float32),
                  "v_scale": jnp.zeros(shape[:3] + (1,), jnp.float32)}
    else:
        jcache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    rng = np.random.default_rng(7)
    for pos in range(5):
        x = rng.standard_normal((b, 1, jac.d_model)).astype(np.float32)
        jo, jcache = jattn.gqa_decode(jp, jac, jnp.asarray(x),
                                      jnp.asarray(pos, jnp.int32), jcache)
        to, tcache = tattn.gqa_decode(tp, tac, torch.from_numpy(x), pos,
                                      tcache)
        assert peak_err(t2n(to), jo) <= 1e-5
    for k in jcache:
        assert tcache[k].dtype == {"k": torch.int8, "v": torch.int8}.get(
            k, torch.float32) if quant else torch.float32
        assert peak_err(t2n(tcache[k]), jcache[k]) <= 1e-5


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def forward_case(name):
    """Jamba and DeepSeek (MLA's absorbed form) with the flash branch on
    both sides (S = 64 > 32); the dense GQA configs at S = 16 (the dense
    branch)."""
    if name == "jamba-v0.1-52b" or name in DEEPSEEK:
        return smoke(name, flash_threshold=32), 64
    return smoke(name), 16


@pytest.mark.parametrize("name", PORTED)
def test_forward_matches_jax(name):
    (jcfg, tcfg), s = forward_case(name)
    jp, tp = params_pair(jcfg)
    toks = tokens(8, (2, s), jcfg.vocab)
    jl, ja, _ = jmodel.forward(jp, jcfg, jnp.asarray(toks))
    tl, ta, _ = tmodel.forward(tp, tcfg, torch.from_numpy(toks).long())
    assert tl.dtype == torch.float32 and tl.shape == (2, s, jcfg.vocab)
    assert peak_err(t2n(tl), jl) <= 1e-4
    assert abs(float(ta) - float(ja)) <= 1e-5


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "qwen3-1.7b"])
def test_prefill_step_matches_jax(name):
    (jcfg, tcfg), s = forward_case(name)
    jp, tp = params_pair(jcfg)
    batch = tokens(9, (2, s + 1), jcfg.vocab)
    jl, jc = jtrainer.make_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(
        batch)})
    tl, tc = ttrainer.make_prefill_step(tcfg)(tp, {
        "tokens": torch.from_numpy(batch).long()})
    assert tl.shape == (2, jcfg.vocab)
    assert peak_err(t2n(tl), jl) <= 1e-4
    jleaves = jax.tree_util.tree_leaves(jc)
    tleaves = jax.tree_util.tree_leaves(lm_params_to_numpy(tc))
    assert len(jleaves) == len(tleaves)
    for jv, tv in zip(jleaves, tleaves):
        assert jv.shape == tv.shape
        assert peak_err(tv, jv) <= 1e-4


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "llama3-8b"])
def test_decode_steps_match_jax(name):
    jcfg, tcfg = smoke(name)
    jp, tp = params_pair(jcfg)
    toks = tokens(10, (2, 8), jcfg.vocab)
    jcache = jmodel.init_cache(jcfg, 2, 16)
    tcache = tmodel.init_cache(tcfg, 2, 16, device="cpu")
    for leaf_j, leaf_t in zip(jax.tree_util.tree_leaves(jcache),
                              jax.tree_util.tree_leaves(tcache)):
        assert tuple(leaf_j.shape) == tuple(leaf_t.shape)
    serve = ttrainer.make_serve_step(tcfg)
    jstep = jax.jit(lambda p, t, pos, c: jmodel.decode_step(p, jcfg, t, pos,
                                                             c))
    for i in range(8):
        jl, jcache = jstep(jp, jnp.asarray(toks[:, i:i + 1]),
                           jnp.asarray(i, jnp.int32), jcache)
        tl, tcache = serve(tp, {"tokens": torch.from_numpy(
            toks[:, i:i + 1]).long()}, i, tcache)
        assert peak_err(t2n(tl), jl[:, -1]) <= 1e-4


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "qwen1.5-32b"])
def test_greedy_generate_matches_jax(name):
    jcfg, tcfg = smoke(name)
    jp, tp = params_pair(jcfg)
    prompt = tokens(11, (2, 4), jcfg.vocab)
    want = jtrainer.greedy_generate(jp, jcfg, jnp.asarray(prompt), 6, 16)
    got = ttrainer.greedy_generate(tp, tcfg, torch.from_numpy(prompt).long(),
                                   6, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", PORTED)
def test_decode_matches_prefill(name):
    """The port's counterpart of ``test_models_smoke.py::
    test_decode_matches_prefill``, on the port's own init, at JAX's
    tolerances (2e-2 hybrid, 2e-3 otherwise).  xLSTM's decode drops the
    mLSTM conv history (as JAX's does), so JAX checks only that it is
    finite; here its 8 decode steps are held against JAX's decode on the
    same (JAX-made) params instead, at 1e-4 of the peak."""
    if name in XLSTM:
        jcfg, tcfg = smoke(name)
        jp, tp = params_pair(jcfg)
        toks = tokens(3, (2, 8), tcfg.vocab)
        jcache = jmodel.init_cache(jcfg, 2, 16)
        cache = tmodel.init_cache(tcfg, 2, 16, device="cpu")
        for i in range(8):
            jl, jcache = jmodel.decode_step(
                jp, jcfg, jnp.asarray(toks[:, i:i + 1]),
                jnp.asarray(i, jnp.int32), jcache)
            lg, cache = tmodel.decode_step(
                tp, tcfg, torch.from_numpy(toks[:, i:i + 1]).long(), i,
                cache)
            assert bool(torch.isfinite(lg).all())
            assert peak_err(t2n(lg), jl) <= 1e-4
        return
    _, tcfg = smoke(name)
    params = tmodel.init_params(tcfg, seed=0, device="cpu")
    toks = torch.from_numpy(tokens(3, (2, 8), tcfg.vocab)).long()
    logits_all, _, _ = tmodel.forward(params, tcfg, toks)
    cache = tmodel.init_cache(tcfg, 2, 16, device="cpu")
    dec = []
    for i in range(8):
        lg, cache = tmodel.decode_step(params, tcfg, toks[:, i:i + 1], i,
                                       cache)
        dec.append(lg[:, 0, :])
    tol = 2e-2 if tcfg.family == "hybrid" else 2e-3
    np.testing.assert_allclose(t2n(torch.stack(dec, 1)), t2n(logits_all),
                               rtol=tol, atol=tol * 10)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(12)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    want = jtrainer.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = ttrainer.cross_entropy(torch.from_numpy(logits),
                                 torch.from_numpy(labels))
    assert abs(float(got) - float(want)) <= 1e-6


# ---------------------------------------------------------------------------
# configs, params, interop, tokens
# ---------------------------------------------------------------------------

def test_registry_and_param_counts_match_jax():
    assert tconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES
    for name in jconfigs.ARCH_NAMES:
        for get in ("get_config", "get_smoke"):
            jcfg = getattr(jconfigs, get)(name)
            tcfg = getattr(tconfigs, get)(name)
            assert tcfg == port_cfg(jcfg)
            assert tbase.param_count(tcfg) == jbase.param_count(jcfg)
            assert tbase.active_param_count(tcfg) == \
                jbase.active_param_count(jcfg)
            assert tbase.runnable_shapes(tcfg) == jbase.runnable_shapes(jcfg)
    assert tbase.SHAPES.keys() == jbase.SHAPES.keys()
    for k in jbase.SHAPES:
        assert dataclasses.asdict(tbase.SHAPES[k]) == \
            dataclasses.asdict(jbase.SHAPES[k])
    jamba = tconfigs.get_config("jamba-v0.1-52b")
    assert jamba.torch_dtype == torch.bfloat16


@pytest.mark.parametrize("name", PORTED)
def test_init_params_tree_matches_jax(name):
    jcfg, tcfg = smoke(name)
    shapes = jax.eval_shape(lambda k: jmodel.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    params = tmodel.init_params(tcfg, seed=0, device="cpu")
    jleaves, jdef = jax.tree_util.tree_flatten_with_path(shapes)
    tleaves, tdef = jax.tree_util.tree_flatten_with_path(params)
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (_, j), (_, t) in zip(jleaves, tleaves):
        assert tuple(t.shape) == tuple(j.shape)
        assert str(t.dtype).replace("torch.", "") == str(j.dtype)
    # the full config's bf16 dtype reaches the leaves, f32 ones stay f32
    bf = dataclasses.replace(tcfg, dtype="bfloat16")
    bp = tmodel.init_params(bf, seed=0, device="cpu")
    assert bp["embed"].dtype == torch.bfloat16


def test_lm_params_round_trip_exact_with_bf16():
    jcfg = dataclasses.replace(jconfigs.get_smoke("jamba-v0.1-52b"),
                               dtype="bfloat16")
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["stack"]["b0"]["mixer"]["A_log"].dtype == torch.float32
    back = lm_params_to_numpy(tp)
    for j, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(j, np.float32)
                                      if j.dtype == jnp.bfloat16
                                      else np.asarray(j), b)


@pytest.mark.parametrize("name", [*DEEPSEEK, *XLSTM])
def test_unported_mixers_raise(name):
    """MLA (the DeepSeek configs) and the xLSTM mixers raised here until
    they were ported; their cases now pin that init_params and forward
    run and match JAX.  xLSTM's analytic ``param_count`` is JAX's, which
    is not its leaf count (queue 3 of ROADMAP.md): its leaves are
    counted against JAX's tree instead."""
    (jcfg, tcfg), s = forward_case(name)          # shares its params
    params = tmodel.init_params(tcfg, seed=0, device="cpu")
    n_leaves = sum(x.numel() for x in jax.tree_util.tree_leaves(params))
    if name in DEEPSEEK:
        assert tbase.param_count(tcfg) == n_leaves
    else:
        shapes = jax.eval_shape(lambda k: jmodel.init_params(jcfg, k),
                                jax.random.PRNGKey(0))
        assert n_leaves == sum(x.size for x in
                               jax.tree_util.tree_leaves(shapes))
        assert tbase.param_count(tcfg) == jbase.param_count(jcfg)
    jp, tp = params_pair(jcfg)
    toks = tokens(13, (2, s), jcfg.vocab)
    jl, _, _ = jmodel.forward(jp, jcfg, jnp.asarray(toks))
    tl, _, _ = tmodel.forward(tp, tcfg, torch.from_numpy(toks).long())
    assert peak_err(t2n(tl), jl) <= 1e-4


def test_ode_depth_raises():
    """``ode_depth`` is train/prefill only: ``decode_step`` raises as
    JAX's does.  (Init and forward raised here until continuous depth was
    ported; ``tests/test_torch_ode_depth.py`` holds them against JAX.)"""
    jcfg, cfg = smoke("llama3-8b", ode_depth=2)
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    assert all(x.shape[0] == 1
               for x in jax.tree_util.tree_leaves(params["stack"]))
    cache = tmodel.init_cache(cfg, 2, 8, device="cpu")
    toks = torch.zeros((2, 1), dtype=torch.long)
    msg = "ODE-depth mode is train/prefill only"
    with pytest.raises(NotImplementedError, match=msg):
        tmodel.decode_step(params, cfg, toks, 0, cache)
    with pytest.raises(NotImplementedError, match=msg):
        jmodel.decode_step(None, jcfg, None, 0, None)


def test_token_pipeline_markov_chain_is_jax_s():
    """The port's draws are torch's, its transition JAX's: every step is
    one of the three successors of JAX's LCG hash, and batches are a pure
    function of (seed, step)."""
    pipe = ttokens.TokenPipeline(vocab=100, seq_len=32, batch=3, seed=4)
    toks = pipe.batch_at(2)["tokens"]
    assert toks.shape == (3, 33)
    assert torch.equal(toks, pipe.batch_at(2)["tokens"])
    assert not torch.equal(toks, pipe.batch_at(3)["tokens"])
    prev = jnp.asarray(toks[:, :-1].numpy().astype(np.int32))
    base = (prev * 1103515245 + 12345) % 64        # JAX's int32 arithmetic
    succ = np.stack([(np.asarray(base) + e) % 100 for e in range(3)])
    assert (succ == toks[:, 1:].numpy()[None]).any(axis=0).all()
    inputs, labels = ttokens.split_batch({"tokens": toks})
    assert torch.equal(inputs, toks[:, :-1]) and torch.equal(labels,
                                                             toks[:, 1:])
    rnd = ttokens.TokenPipeline(vocab=100, seq_len=8, batch=2,
                                mode="random").batch_at(0)["tokens"]
    assert rnd.shape == (2, 9) and int(rnd.max()) < 100
    jtoks = jtokens.TokenPipeline(vocab=100, seq_len=32, batch=3,
                                  seed=4).batch_at(2)["tokens"]
    assert jtoks.shape == tuple(toks.shape)
