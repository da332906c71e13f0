"""The tuned-config knobs of the port (``get_tuned_config``: ``qchunk`` and
``flashref`` attention, ``decode_inplace``, ``save_proj_remat``) against
the JAX reference on the CPU, in float32 unless stated.

Inputs are drawn with numpy from a seed and go through the reference's
function and the port's.  Tolerances: ``qchunk_attention`` within 1e-5 abs
and rel (2e-2 with bf16 probabilities); ``flashref_attention``'s output
within 1e-5 and its dq, dk, dv within 1e-4 in relative 2-norm of
``jax.grad`` through the reference's ``custom_vjp``; a decode step's
logits and stacked cache within 1e-4 (both packages start from one random
cache, bf16 as in both); ``save_proj_remat``'s loss
within 1e-5 relative and every gradient leaf within 1e-5 in relative 2-norm
of the reference's, and within 1e-6 of the port's plain remat; the ten
tuned smoke configs against the reference's golden fixtures
(``tests/make_torch_golden.py --only tuned``) as the families' fixtures are
held (logits 1e-4, tokens equal, loss and grad norm 1e-5), except that
``tp_bf16_reduce`` makes the logits and grad norm bf16 values
(``tuned_golden_tol``).

No test here starts a process, initialises ``torch.distributed`` or sets
global state.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from family_oracle import (FIXTURES, configs, jax_batch, leaves, numpy_batch,
                           port, to_numpy, torch_batch)
from repro.configs.base import ARCH_IDS as JAX_ARCH_IDS
from repro.configs.base import get_tuned_config as jax_tuned_config
from repro.models import layers as jax_layers
from repro.models.api import build as jax_build
from repro_torch.configs.base import ARCH_IDS, ShapeCell, get_config, \
    get_tuned_config
from repro_torch.convert import export_params, load_reference_params, \
    tree_from_flat
from repro_torch.launch import serve
from repro_torch.launch.steps import make_optimizer, make_train_step
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.models.api import build, make_batch

GOLDEN_TOL = {"logits": 1e-4, "loss": 1e-5, "grad_norm": 1e-5, "lr": 1e-6}


def qkv(seed, B, Sq, Skv, H, KV, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd), dtype=np.float32),
            rng.standard_normal((B, Skv, KV, hd), dtype=np.float32),
            rng.standard_normal((B, Skv, KV, hd), dtype=np.float32))


def reference(jcfg):
    """(reference api, params from PRNGKey(0) under ``jax.jit``: a third of
    the eager init's time, other bits than it, the same in both packages)."""
    api = jax_build(jcfg)
    return api, jax.jit(lambda key: api.init(key)[0])(jax.random.PRNGKey(0))


def rel_2norm(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------------------------------
# qchunk_attention
# ---------------------------------------------------------------------------

# (causal, H, KV, Sq, Skv, q_block, q_offset, probs_dtype)
QCHUNK = [
    (True, 4, 4, 40, 40, 16, 0, "float32"),      # last chunk padded
    (False, 4, 4, 40, 40, 16, 0, "float32"),
    (True, 4, 2, 48, 48, 16, 0, "float32"),      # GQA 2, whole chunks
    (True, 8, 2, 37, 37, 8, 0, "float32"),       # GQA 4
    (False, 8, 2, 20, 52, 16, 0, "float32"),     # Sq != Skv
    (True, 4, 2, 21, 29, 8, 8, "float32"),       # q_offset > 0
    (True, 4, 2, 40, 40, 512, 0, "float32"),     # one chunk of Sq rows
    (True, 4, 2, 40, 40, 16, 0, "bfloat16"),
    (False, 8, 2, 33, 33, 16, 0, "bfloat16"),
]


@pytest.mark.parametrize("case", QCHUNK, ids=lambda c: "-".join(map(str, c)))
def test_qchunk_attention_matches_reference(case):
    causal, H, KV, Sq, Skv, qb, off, pdt = case
    q, k, v = qkv(1, 2, Sq, Skv, H, KV, 16)
    want = jax_layers.qchunk_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=off, q_block=qb, probs_dtype=getattr(jnp, pdt))
    got = layers.qchunk_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, q_offset=off, q_block=qb,
        probs_dtype=getattr(torch, pdt))
    tol = 1e-5 if pdt == "float32" else 2e-2
    assert got.shape == (2, Sq, H, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def test_qchunk_attention_keeps_bf16_inputs_bf16():
    q, k, v = qkv(2, 1, 24, 24, 4, 2, 16)
    want = jax_layers.qchunk_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), causal=True, q_block=16)
    got = layers.qchunk_attention(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), causal=True,
        q_block=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


# ---------------------------------------------------------------------------
# flashref_attention: forward and the custom backward
# ---------------------------------------------------------------------------

# (causal, H, KV, Sq, Skv, q_block)
FLASHREF = [
    (True, 4, 4, 48, 48, 16),        # whole chunks
    (True, 4, 2, 40, 40, 16),        # GQA 2, last chunk padded
    (False, 8, 2, 37, 37, 16),       # GQA 4, non-causal, padded
    (False, 4, 4, 20, 52, 8),        # cross-attention shape
    (True, 4, 1, 30, 30, 512),       # one chunk, MQA
]


@pytest.mark.parametrize("case", FLASHREF,
                         ids=lambda c: "-".join(map(str, c)))
def test_flashref_forward_and_gradients_match_reference(case):
    causal, H, KV, Sq, Skv, qb = case
    q, k, v = qkv(3, 2, Sq, Skv, H, KV, 16)
    do = np.random.default_rng(4).standard_normal((2, Sq, H, 16),
                                                  dtype=np.float32)

    def jfn(q, k, v):
        return jax_layers.flashref_attention(q, k, v, causal, qb,
                                             jnp.float32)
    want, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_g = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = layers.flashref_attention(tq, tk, tv, causal, qb, torch.float32)
    got.backward(torch.from_numpy(do))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want_g):
        assert g.shape == w.shape
        assert rel_2norm(g.numpy(), w) <= 1e-4, f"d{name}"


def test_flashref_saves_only_q_k_v_out_and_logsumexp():
    q, k, v = qkv(5, 1, 40, 40, 4, 2, 16)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        layers.flashref_attention(tq, tk, tv, True, 16)
    assert saved == [(1, 40, 4, 16), (1, 40, 2, 16), (1, 40, 2, 16),
                     (1, 40, 4, 16), (1, 2, 2, 40)]


@pytest.mark.parametrize("causal", [True, False])
def test_flashref_gradcheck_float64(causal):
    q, k, v = (torch.from_numpy(a).double().requires_grad_()
               for a in qkv(6, 1, 5, 5, 2, 1, 4))

    def fn(q, k, v):
        return layers.flashref_attention(q, k, v, causal, 2, torch.float64)
    assert torch.autograd.gradcheck(fn, (q, k, v))


# ---------------------------------------------------------------------------
# decode_inplace
# ---------------------------------------------------------------------------

INPLACE_ARCHS = ("tinyllama_1_1b", "deepseek_moe_16b", "internvl2_1b")


def numpy_cache(cfg, seed, batch=2, max_seq=12):
    """A decode cache of standard normal values rounded to bf16 (the dtype
    of both packages' caches), as float32 arrays."""
    rng = np.random.default_rng(seed)
    n_dense = T.n_dense_layers(cfg)
    shape = (batch, max_seq, cfg.kv_heads, cfg.hd)
    groups = {"main": cfg.n_layers - n_dense}
    if n_dense:
        groups["dense"] = n_dense
    return {name: tuple(np.asarray(torch.from_numpy(rng.standard_normal(
        (n, *shape), dtype=np.float32)).bfloat16().float())
        for _ in range(2)) for name, n in groups.items()}


def torch_cache(nc):
    return {name: tuple(torch.from_numpy(t).bfloat16() for t in pair)
            for name, pair in nc.items()}


@pytest.fixture(scope="module", params=INPLACE_ARCHS)
def decoded(request):
    """One decode step at index 9 of a 12-position cache: the reference
    with ``decode_inplace``, the port's in-place and copying decodes, all
    from the same cache and token."""
    arch = request.param
    jcfg, tcfg = configs(arch, param_dtype="float32", decode_inplace=True)
    japi, params = reference(jcfg)
    nc = numpy_cache(tcfg, 7)
    tok = np.random.default_rng(8).integers(0, jcfg.vocab, (2,))
    jcache = {name: tuple(jnp.asarray(t, jnp.bfloat16) for t in pair)
              for name, pair in nc.items()}
    want = jax.jit(japi.decode)(params, jcache, jnp.asarray(tok, jnp.int32),
                                jnp.int32(9))
    api = port(tcfg, params)
    tok_t = torch.from_numpy(tok)
    given = torch_cache(nc)
    api.model.cfg = dataclasses.replace(tcfg, decode_inplace=False)
    copy_out = api.decode(torch_cache(nc), tok_t, 9)
    api.model.cfg = tcfg
    got = api.decode(given, tok_t, 9)
    return {"want": want, "got": got, "copy": copy_out, "given": given}


def test_decode_inplace_matches_reference(decoded):
    (wl, wc), (gl, gc) = decoded["want"], decoded["got"]
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=1e-4,
                               rtol=1e-4)
    assert sorted(gc) == sorted(wc)
    for name in wc:
        for g, w in zip(gc[name], wc[name]):
            assert g.dtype == torch.bfloat16 and g.shape == w.shape
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(w, np.float32), atol=1e-4,
                                       rtol=1e-4, err_msg=name)


def test_decode_inplace_is_bit_equal_to_the_copying_decode(decoded):
    (gl, gc), (cl, cc) = decoded["got"], decoded["copy"]
    assert torch.equal(gl, cl)
    for name in cc:
        for g, c in zip(gc[name], cc[name]):
            assert torch.equal(g, c), name


def test_decode_inplace_returns_the_given_stack(decoded):
    _, gc = decoded["got"]
    for name, pair in decoded["given"].items():
        for g, given in zip(gc[name], pair):
            assert g is given
            assert g.untyped_storage().data_ptr() == \
                given.untyped_storage().data_ptr()


def test_decode_inplace_leaves_prefill_and_extra_embeds_on_the_copy_path():
    _, tcfg = configs("internvl2_1b", param_dtype="float32",
                      decode_inplace=True)
    api = build(tcfg, device="cpu")
    nb = numpy_batch(tcfg, 8, batch=1, seq=6, labels=False)
    cache = T.init_kv_cache(tcfg, 1, 6 + tcfg.vision_tokens, "cpu")
    before = [t.clone() for t in cache["main"]]
    with torch.no_grad():
        _, new, _ = api.model(torch.from_numpy(nb["tokens"]),
                              extra_embeds=torch.from_numpy(nb["vision"]),
                              kv_caches=cache, cache_index=0)
    assert new["main"][0] is not cache["main"][0]
    assert all(torch.equal(a, b) for a, b in zip(before, cache["main"]))


# ---------------------------------------------------------------------------
# save_proj_remat
# ---------------------------------------------------------------------------

PROJ_ARCHS = ("tinyllama_1_1b", "deepseek_moe_16b")


def port_loss_and_grads(api, batch):
    loss = api.loss(batch)
    names = [n for n, _ in api.model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       api.model.named_parameters()])
    return float(loss), leaves(export_params(dict(zip(names, grads))))


@pytest.mark.parametrize("arch", PROJ_ARCHS)
def test_save_proj_remat_matches_reference_and_plain_remat(arch):
    jcfg, tcfg = configs(arch, param_dtype="float32", remat=True,
                         save_proj_remat=True)
    japi, params = reference(jcfg)
    nb = numpy_batch(jcfg, 9, batch=2, seq=24)
    want_l, want_g = jax.jit(jax.value_and_grad(japi.loss))(params,
                                                            jax_batch(nb))
    api = port(tcfg, params)
    got_l, got_g = port_loss_and_grads(api, torch_batch(nb))
    np.testing.assert_allclose(got_l, float(want_l), rtol=1e-5)
    want_g = leaves(to_numpy(want_g))
    assert sorted(got_g) == sorted(want_g)
    for name, w in want_g.items():
        assert rel_2norm(got_g[name], w) <= 1e-5, name
    api.model.cfg = dataclasses.replace(tcfg, save_proj_remat=False)
    plain_l, plain_g = port_loss_and_grads(api, torch_batch(nb))
    assert abs(got_l - plain_l) <= 1e-6 * abs(plain_l)
    for name, p in plain_g.items():
        assert rel_2norm(got_g[name], p) <= 1e-6, name


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", PROJ_ARCHS)
def test_save_proj_remat_keeps_the_two_projections_and_recomputes_the_rest(
        arch, monkeypatch):
    """What a layer keeps beyond plain remat is the outputs of its two
    projections, [B * S, D] each: the policy's MUST_SAVE decisions in the
    forward are counted (the selective checkpoint stores them itself, out of
    reach of ``saved_tensors_hooks``, which see the same tensors in both
    modes).  The backward's replay skips the product by ``wo``; in a
    dense layer the one by ``w_down`` is the last op that saves tensors for
    the backward, and plain remat's replay already stops before it runs
    (non-reentrant checkpoint's early stop)."""
    _, tcfg = configs(arch, param_dtype="float32", remat=True)
    api = build(tcfg, device="cpu")
    batch = torch_batch(numpy_batch(tcfg, 10, batch=2, seq=16))
    kept = []
    make_policy = T.save_proj_policy

    def counting_policy(layer):
        policy = make_policy(layer)

        def spy(ctx, func, *args, **kwargs):
            out = policy(ctx, func, *args, **kwargs)
            if not ctx.is_recompute and \
                    out == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE:
                kept.append((layer, tuple(args[0].shape[:1]) +
                             tuple(args[1].shape[1:])))
            return out
        return spy
    monkeypatch.setattr(T, "save_proj_policy", counting_policy)

    def run(save_proj):
        api.model.cfg = dataclasses.replace(tcfg, save_proj_remat=save_proj)
        hooked = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: hooked.append(tuple(t.shape)) or t, lambda t: t):
            loss = api.loss(batch)
        mode = _CountMM()
        with mode:
            loss.backward()
        api.model.zero_grad()
        return sorted(hooked), mode.n

    hooked_plain, mm_plain = run(False)
    assert kept == []
    hooked_proj, mm_proj = run(True)
    layers_ = list(getattr(api.model, "dense_layers", [])) + \
        list(api.model.layers)
    B, S, D = 2, 16, tcfg.d_model
    assert kept == [(layer, (B * S, D)) for layer in layers_
                    for _ in T.proj_weights(layer)]
    assert all(len(T.proj_weights(layer)) == 2 for layer in layers_)
    assert hooked_proj == hooked_plain
    # a MoE layer ends with its routed experts' combine, after the shared
    # experts' w_down: there the replay skips both projections
    assert mm_plain - mm_proj == sum(2 if hasattr(layer, "moe") else 1
                                     for layer in layers_)


# ---------------------------------------------------------------------------
# get_tuned_config: every arch
# ---------------------------------------------------------------------------

def test_tuned_configs_equal_the_references():
    assert ARCH_IDS == JAX_ARCH_IDS
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_tuned_config(arch, smoke=True)) == \
            dataclasses.asdict(jax_tuned_config(arch, smoke=True))


def tuned_golden_tol(variant: str) -> dict:
    """The fixtures' tolerances: ``tp_bf16_reduce`` rounds each projection
    output to bf16 in both packages, so where their float32 values differ
    in the last bits a few elements round to neighbouring bf16 values; the
    logits and the grad norm after it are held as bf16 values are (D10),
    the loss stays within 1e-5.  Without it every gate is float32's."""
    if variant == "no_bf16_reduce":
        return GOLDEN_TOL
    return {**GOLDEN_TOL, "logits": 2e-2, "grad_norm": 2e-2}


@pytest.mark.parametrize("variant", ["tuned", "no_bf16_reduce"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_port_cpu_path_reproduces_the_tuned_golden_fixture(arch, variant):
    """The reference's tuned smoke config (float32): the serving loop's
    prefill logits (the cached prefill through ``qchunk_attention`` in two
    chunks) and greedy tokens, and one training step (``flashref`` and
    ``save_proj_remat``) at the fixture's loss, grad norm and lr; as
    published and without ``tp_bf16_reduce``."""
    fx = dict(np.load(FIXTURES / f"golden_tuned_{arch}.npz"))
    cfg = dataclasses.replace(get_tuned_config(arch, smoke=True),
                              param_dtype="float32")
    assert str(fx["attn_impl"]) == cfg.attn_impl
    want = fx
    if variant == "no_bf16_reduce":
        if not cfg.tp_bf16_reduce:
            assert not any(k.startswith(variant) for k in fx)
            return
        cfg = dataclasses.replace(cfg, tp_bf16_reduce=False)
        want = {k.split(":", 1)[1]: v for k, v in fx.items()
                if k.startswith(f"{variant}:")}
    tol = tuned_golden_tol(variant)
    api = build(cfg, device="cpu")
    load_reference_params(api.model,
                          tree_from_flat(fx, "param:", api.model))
    sv = {k.split(":", 1)[1]: torch.from_numpy(v) for k, v in fx.items()
          if k.startswith("serve:")}
    out = serve.generate(api, sv, int(fx["prompt_len"]), int(fx["gen"]))
    np.testing.assert_allclose(out.prefill_logits.numpy(),
                               want["prefill_logits"], atol=tol["logits"],
                               rtol=0)
    np.testing.assert_array_equal(out.tokens.numpy(), want["greedy_tokens"])
    tb = {k.split(":", 1)[1]: torch.from_numpy(v) for k, v in fx.items()
          if k.startswith("train:")}
    opt = make_optimizer(cfg, total_steps=1)
    params = dict(api.model.named_parameters())
    _, _, m = make_train_step(api, opt)(params, opt.init(params), tb)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(want[k]),
                                   rtol=tol[k], err_msg=k)


# the port's versions of tests/test_system.py's test_opt_flags_preserve_loss
# and test_tuned_configs_preserve_loss, at a sequence (288) whose scores
# pass the 256 x 256 limit, so qchunk and flashref run
OPT_FLAGS = ({"ce_recompute": True}, {"attn_impl": "qchunk"},
             {"attn_impl": "flashref"}, {"attn_probs_dtype": "bfloat16"},
             {"tp_bf16_reduce": True}, {"save_proj_remat": True})
PRESERVE_SHAPE = ShapeCell("t", "train", 288, 2)


def preserve_loss(cfg, batch) -> float:
    api = build(cfg, device="cpu",
                generator=torch.Generator().manual_seed(0))
    return float(api.loss(batch))


@pytest.mark.parametrize("overrides", OPT_FLAGS,
                         ids=lambda o: "-".join(f"{k}={v}"
                                                for k, v in o.items()))
def test_opt_flags_preserve_loss(overrides):
    cfg = get_config("tinyllama_1_1b", smoke=True)
    batch = make_batch(cfg, torch.Generator().manual_seed(1),
                       PRESERVE_SHAPE, device="cpu")
    base = preserve_loss(cfg, batch)
    val = preserve_loss(dataclasses.replace(cfg, **overrides), batch)
    assert abs(val - base) < 0.05, (overrides, val, base)


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "phi3_5_moe",
                                  "mamba2_130m"])
def test_tuned_configs_preserve_loss(arch):
    cfg = get_config(arch, smoke=True)
    batch = make_batch(cfg, torch.Generator().manual_seed(1),
                       PRESERVE_SHAPE, device="cpu")
    base = preserve_loss(cfg, batch)
    tuned = preserve_loss(get_tuned_config(arch, smoke=True), batch)
    assert abs(tuned - base) < 0.05, (arch, base, tuned)
