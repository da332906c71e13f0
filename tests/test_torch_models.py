"""The port's hybrid (Zamba2) and SSM (Mamba-2) serving path against the
JAX reference (CPU).

The reference is initialised from ``PRNGKey(0)`` and its parameters are
loaded into the port (``repro_torch.convert.load_reference_params``); both
then see the same numpy tokens.  With ``attn_impl="flash"`` the reference
runs its Pallas kernels in interpret mode and the port its kernels' plain
versions.  Tolerances, elementwise, abs and rel: float32 logits and caches
within 1e-4; bfloat16 logits within 2e-2, the reference's own bf16
tolerance (both sides round each layer to bf16, at slightly different
places).  A bfloat16 decode cache is held within 5e-2 in relative 2-norm:
an SSM state element is a product of three bf16-rounded values, and where
the conv before it cancels a single element can be far off in relative
terms; the states drift apart with depth as the residual streams do (XLA
rounds a fused bf16 chain once, PyTorch after each op).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models import hybrid as jax_hybrid
from repro.models import layers as jax_layers
from repro.models import mamba2 as jax_mamba
from repro_torch.configs.base import get_config
from repro_torch.convert import load_reference_params
from repro_torch.models import layers, mamba2
from repro_torch.models.api import build

FAMILIES = {"zamba2_2_7b": jax_hybrid, "mamba2_130m": jax_mamba}
CASES = [(arch, impl, dtype) for arch in FAMILIES
         for impl in ("ref", "flash") for dtype in ("float32", "bfloat16")]


def to_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def configs(arch, **kw):
    return (dataclasses.replace(jax_config(arch, smoke=True), **kw),
            dataclasses.replace(get_config(arch, smoke=True), **kw))


def close(got, want, dtype, what, norm=False):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    tol = 1e-4 if dtype == "float32" else 2e-2
    if norm and dtype == "bfloat16":
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= 5e-2, f"{what}: relative 2-norm error {err}"
    else:
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol,
                                   err_msg=what)


@pytest.fixture(scope="module", params=CASES,
                ids=["-".join(c) for c in CASES])
def served(request):
    """Prefill and one decode step through both packages."""
    arch, impl, dtype = request.param
    jcfg, tcfg = configs(arch, attn_impl=impl, param_dtype=dtype)
    fam = FAMILIES[arch]
    params, _ = fam.init_lm(jax.random.PRNGKey(0), jcfg)
    api = build(tcfg, device="cpu")
    load_reference_params(api.model, to_numpy(params))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 40))
    j_logits, j_cache = jax.jit(fam.prefill, static_argnums=1)(
        params, jcfg, jnp.asarray(tokens, jnp.int32))
    t_logits, t_cache = api.prefill({"tokens": torch.from_numpy(tokens)})
    tok = np.asarray(jnp.argmax(j_logits, -1))
    j_logits2, j_cache2 = jax.jit(fam.decode_step, static_argnums=1)(
        params, jcfg, j_cache, jnp.asarray(tok, jnp.int32), jnp.int32(33))
    t_logits2, t_cache2 = api.decode(t_cache, torch.tensor(tok).long(),
                                     33)
    return dtype, (j_logits, j_cache, j_logits2, j_cache2), \
        (t_logits, t_cache, t_logits2, t_cache2)


def test_prefill_logits_match(served):
    dtype, j, t = served
    close(t[0], j[0], dtype, "prefill logits")


def test_prefill_returns_the_references_zero_cache(served):
    dtype, j, t = served
    assert sorted(t[1]) == sorted(j[1])
    for key in j[1]:
        assert tuple(t[1][key].shape) == j[1][key].shape, key
        assert str(t[1][key].dtype).split(".")[-1] == str(j[1][key].dtype)
        assert not bool(t[1][key].any()) and not np.asarray(j[1][key]).any()


def test_decode_step_logits_and_cache_match(served):
    dtype, j, t = served
    close(t[2], j[2], dtype, "decode logits")
    assert sorted(t[3]) == sorted(j[3])
    for key in j[3]:
        assert str(t[3][key].dtype).split(".")[-1] == str(j[3][key].dtype)
        close(t[3][key], j[3][key], dtype, f"cache {key}", norm=True)


# ---------------------------------------------------------------------------
# the blocks one by one (float32)
# ---------------------------------------------------------------------------

def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def test_norms_and_rope_match():
    x, g = _x((2, 5, 48), 0), _x((48,), 1)
    for name in ("rmsnorm", "layernorm"):
        want = getattr(jax_layers, name)(jnp.asarray(x), jnp.asarray(g))
        got = getattr(layers, name)(torch.from_numpy(x), torch.from_numpy(g))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
    q = _x((2, 7, 3, 16), 2)
    for frac in (1.0, 0.5):
        inv_j = jax_layers.rope_freqs(16, frac)
        inv_t = layers.rope_freqs(16, frac)
        np.testing.assert_allclose(inv_t.numpy(), np.asarray(inv_j),
                                   rtol=1e-6)
        want = jax_layers.apply_rope(jnp.asarray(q), jnp.arange(7) + 3,
                                     inv_j)
        got = layers.apply_rope(torch.from_numpy(q), torch.arange(7) + 3,
                                inv_t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def attention():
    jcfg, tcfg = configs("zamba2_2_7b", param_dtype="float32")
    p, _ = jax_layers.init_attention(jax.random.PRNGKey(3), jcfg,
                                     jnp.float32)
    mod = layers.Attention(tcfg, torch.float32, "cpu",
                           torch.Generator().manual_seed(0))
    load_reference_params(mod, to_numpy(p))
    return jcfg, tcfg, p, mod


@pytest.mark.parametrize("impl,S", [("ref", 24), ("flash", 24),
                                    ("ref", 300)])
def test_attention_block_without_cache(attention, impl, S):
    jcfg, tcfg, p, mod = attention
    jcfg = dataclasses.replace(jcfg, attn_impl=impl)
    tcfg = dataclasses.replace(tcfg, attn_impl=impl)
    x = _x((2, S, jcfg.d_model), 4)
    inv_j, inv_t = jax_layers.rope_freqs(jcfg.hd, 1.0), \
        layers.rope_freqs(tcfg.hd, 1.0)
    want, _ = jax_layers.attention_block(
        p, jcfg, jnp.asarray(x), positions=jnp.arange(S), inv_freqs=inv_j)
    with torch.no_grad():
        got, _ = layers.attention_block(
            mod, tcfg, torch.from_numpy(x), positions=torch.arange(S),
            inv_freqs=inv_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("S", [1, 6])
def test_attention_block_with_cache(attention, S):
    """S == 1: the decode branch; S > 1: the cached prefill branch."""
    jcfg, tcfg, p, mod = attention
    x = _x((2, S, jcfg.d_model), 5)
    ck = _x((2, 16, jcfg.kv_heads, jcfg.hd), 6)
    cv = _x((2, 16, jcfg.kv_heads, jcfg.hd), 7)
    idx = 9
    inv_j, inv_t = jax_layers.rope_freqs(jcfg.hd, 1.0), \
        layers.rope_freqs(tcfg.hd, 1.0)
    want, (wk, wv) = jax_layers.attention_block(
        p, jcfg, jnp.asarray(x), positions=idx + jnp.arange(S),
        kv_cache=(jnp.asarray(ck), jnp.asarray(cv)), cache_index=idx,
        inv_freqs=inv_j)
    with torch.no_grad():
        got, (gk, gv) = layers.attention_block(
            mod, tcfg, torch.from_numpy(x), positions=idx + torch.arange(S),
            kv_cache=(torch.from_numpy(ck), torch.from_numpy(cv)),
            cache_index=idx, inv_freqs=inv_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=1e-5)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-5)


@pytest.mark.parametrize("impl", ["ref", "flash"])
def test_mamba_block_prefill_and_decode(impl):
    jcfg, tcfg = configs("zamba2_2_7b", param_dtype="float32",
                         attn_impl=impl)
    p, _ = jax_mamba.init_mamba_block(jax.random.PRNGKey(5), jcfg,
                                      jnp.float32)
    p = dict(p, A_log=jnp.linspace(-1.0, 1.0, p["A_log"].shape[0]),
             dt_bias=jnp.linspace(-0.5, 0.5, p["dt_bias"].shape[0]))
    blk = mamba2.MambaBlock(tcfg, torch.float32, "cpu",
                            torch.Generator().manual_seed(0))
    load_reference_params(blk, to_numpy(p))
    u = _x((2, 45, jcfg.d_model), 8)
    want, _, _ = jax_mamba.mamba_block(p, jcfg, jnp.asarray(u))
    with torch.no_grad():
        got, _, _ = mamba2.mamba_block(blk, tcfg, torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)

    d_in, nh, n, conv_dim, _ = mamba2.block_dims(tcfg)
    ssm = _x((2, nh, tcfg.ssm_head_dim, n), 9)
    conv = _x((2, mamba2.CONV_K - 1, conv_dim), 10)
    want = jax_mamba.mamba_block(p, jcfg, jnp.asarray(u[:, :1]),
                                 ssm_state=jnp.asarray(ssm),
                                 conv_state=jnp.asarray(conv))
    with torch.no_grad():
        got = mamba2.mamba_block(blk, tcfg, torch.from_numpy(u[:, :1]),
                                 ssm_state=torch.from_numpy(ssm),
                                 conv_state=torch.from_numpy(conv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


def test_unported_branches_say_so(attention):
    """Named when these branches still raised naming A9: the ``qchunk``
    branch of a cache-less call past 256 x 256 and the ``decode_inplace``
    stacked-cache branch now equal the reference's."""
    jcfg, tcfg, p, mod = attention
    jcfg = dataclasses.replace(jcfg, attn_impl="qchunk")
    tcfg = dataclasses.replace(tcfg, attn_impl="qchunk")
    inv_j, inv_t = jax_layers.rope_freqs(jcfg.hd, 1.0), \
        layers.rope_freqs(tcfg.hd, 1.0)
    x = _x((1, 300, jcfg.d_model), 8)
    want, _ = jax_layers.attention_block(
        p, jcfg, jnp.asarray(x), positions=jnp.arange(300), inv_freqs=inv_j)
    with torch.no_grad():
        got, _ = layers.attention_block(
            mod, tcfg, torch.from_numpy(x), positions=torch.arange(300),
            inv_freqs=inv_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    # one token into layer 1 of a 3-layer stack at index 5 of 8 positions
    stack = _x((2, 3, 2, 8, jcfg.kv_heads, jcfg.hd), 9)
    x = _x((2, 1, jcfg.d_model), 10)
    want, (wk, wv) = jax_layers.attention_block(
        p, jcfg, jnp.asarray(x), positions=jnp.arange(1) + 5,
        cache_index=5, inv_freqs=inv_j,
        stacked_cache=(jnp.asarray(stack[0]), jnp.asarray(stack[1])),
        layer_index=1)
    tk, tv = torch.from_numpy(stack[0]), torch.from_numpy(stack[1])
    with torch.no_grad():
        got, (gk, gv) = layers.attention_block(
            mod, tcfg, torch.from_numpy(x), positions=torch.arange(1) + 5,
            cache_index=5, inv_freqs=inv_t, stacked_cache=(tk, tv),
            layer_index=1)
    assert gk is tk and gv is tv
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=1e-5)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-5)
    # the MoE family is ported (tests/test_torch_moe.py): it builds
    moe = dataclasses.replace(get_config("deepseek_moe_16b", smoke=True),
                              param_dtype="float32")
    api = build(moe, device="cpu")
    assert len(api.model.dense_layers) == moe.moe_first_dense
    assert all(hasattr(layer, "moe") for layer in api.model.layers)
