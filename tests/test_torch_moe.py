"""The MoE family (deepseek-moe-16b, phi3.5-moe smoke configs) against the
JAX reference (CPU).

The MoE block alone: the expert picks exactly (as a set per token, since
``torch.topk`` and ``lax.top_k`` may order ties differently), the capacity
drops exactly (a numpy oracle of the reference's rule: routed rows in stable
(expert, token) order, the first C of each expert kept), the gates, the
block's output and its aux loss within 1e-4 in float32; in bfloat16 the
output within 2e-2 on the tokens whose picks and drops agree, with the
number of differing picks reported.  Then the model: prefill logits, one
decode step and its cache (``dense`` and ``main``), the loss and every
gradient leaf, one optimizer step, with ``attn_impl`` ``"ref"`` and
``"flash"`` (the Pallas kernels in interpret mode against the kernels'
plain versions); and the parameter tree carried both ways by ``convert``.
Tolerances are ``tests/family_oracle.py``'s.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from family_oracle import (TOL, assert_trees_close, cache_close, close,
                           configs, jax_batch, numpy_batch, port, reference,
                           to_numpy, torch_batch)
from repro.launch.steps import make_optimizer as jax_make_optimizer
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import layers as jax_layers
from repro.models.api import build as jax_build
from repro_torch.backends.tpu_graph import capture_graph
from repro_torch.convert import export_params, load_reference_params
from repro_torch.launch.steps import make_optimizer, make_train_step
from repro_torch.models import layers
from repro_torch.models.api import TensorSpec

ARCHS = ("deepseek_moe_16b", "phi3_5_moe")
CASES = [(arch, impl, dtype) for arch in ARCHS
         for impl in ("ref", "flash") for dtype in ("float32", "bfloat16")]


def first_moe(tree):
    """The first MoE layer's parameters of a reference tree."""
    return jax.tree.map(lambda a: a[0], tree["layers"]["moe"])


def block_inputs(arch, dtype, seed=0, seq=24):
    jcfg, tcfg = configs(arch, param_dtype=dtype)
    japi, params = reference(jcfg)
    api = port(tcfg, params)
    x = np.random.default_rng(seed).standard_normal(
        (2, seq, jcfg.d_model), dtype=np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jcfg, tcfg, first_moe(params), api.model.layers[0].moe, jx, tx


def reference_routing(jcfg, p, jx, capacity_factor):
    """The reference's picks and gates (``moe_block``'s own lines), and its
    capacity rule in numpy: keep [T, K]."""
    E, K = jcfg.moe_experts, jcfg.moe_topk
    xt = jx.reshape(-1, jx.shape[-1])
    logits = jnp.einsum("td,de->te", xt.astype(jnp.float32), p["router"])
    gates, idx = jax.lax.top_k(jax.nn.softmax(logits, -1), K)
    gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
    idx = np.asarray(idx)
    T = idx.shape[0]
    C = max(1, int(capacity_factor * K * T / E))
    keep = np.zeros(T * K, bool)
    seen = collections.Counter()
    for flat in np.argsort(idx.reshape(-1), kind="stable"):
        e = idx.reshape(-1)[flat]
        keep[flat] = seen[e] < C
        seen[e] += 1
    return np.asarray(gates), idx, keep.reshape(T, K), C


def port_keep(route):
    """The port's keep flags back in (token, pick) order: [T, K]."""
    keep = torch.zeros_like(route["keep"])
    keep[route["order"]] = route["keep"]
    return keep.reshape(route["idx"].shape).numpy()


def same_picks(a, b):
    """Per token, the same set of experts: [T] bool."""
    return np.array([set(x) == set(y) for x, y in zip(a, b)])


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference_in_float32(arch, capacity_factor):
    jcfg, tcfg, jp, tp, jx, tx = block_inputs(arch, "float32")
    gates, idx, keep, C = reference_routing(jcfg, jp, jx, capacity_factor)
    with torch.no_grad():
        route = layers.moe_route(tp, tcfg, tx.reshape(-1, tcfg.d_model),
                                 capacity_factor)
        y, aux = layers.moe_block(tp, tcfg, tx, capacity_factor)
    t_idx = route["idx"].numpy()
    assert same_picks(t_idx, idx).all()
    # the gates of each token's picks, matched by expert
    order_t, order_j = np.argsort(t_idx, 1), np.argsort(idx, 1)
    np.testing.assert_allclose(
        np.take_along_axis(route["gates"].numpy(), order_t, 1),
        np.take_along_axis(gates, order_j, 1), atol=TOL["float32"],
        rtol=TOL["float32"])
    assert route["capacity"] == C
    t_keep = port_keep(route)
    np.testing.assert_array_equal(np.take_along_axis(t_keep, order_t, 1),
                                  np.take_along_axis(keep, order_j, 1))
    if capacity_factor < 1:
        assert not keep.all()             # the case drops routed rows
    jy, jaux = jax_layers.moe_block(jp, jcfg, jx, capacity_factor)
    close(y, jy, "float32", "moe output")
    np.testing.assert_allclose(float(aux), float(jaux),
                               rtol=TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_in_bfloat16_where_the_picks_agree(arch, capsys):
    jcfg, tcfg, jp, tp, jx, tx = block_inputs(arch, "bfloat16", seed=3)
    _, idx, keep, _ = reference_routing(jcfg, jp, jx, 1.25)
    with torch.no_grad():
        route = layers.moe_route(tp, tcfg, tx.reshape(-1, tcfg.d_model))
        y, aux = layers.moe_block(tp, tcfg, tx)
    t_idx = route["idx"].numpy()
    agree = same_picks(t_idx, idx)
    order_t, order_j = np.argsort(t_idx, 1), np.argsort(idx, 1)
    agree &= (np.take_along_axis(port_keep(route), order_t, 1) ==
              np.take_along_axis(keep, order_j, 1)).all(1)
    differing = int(sum(len(set(a) ^ set(b)) // 2
                        for a, b in zip(t_idx, idx)))
    with capsys.disabled():
        print(f"\n{arch} bf16: {differing} of {idx.size} picks differ, "
              f"{int(agree.sum())} of {len(agree)} tokens compared")
    assert agree.any()
    jy, jaux = jax_layers.moe_block(jp, jcfg, jx)
    rows = agree.reshape(jx.shape[:2])
    close(y.float()[torch.from_numpy(rows)],
          np.asarray(jy, np.float32)[rows], "bfloat16", "moe output")
    if differing == 0:
        np.testing.assert_allclose(float(aux), float(jaux),
                                   rtol=TOL["bfloat16"])


class _Block(torch.nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.moe = layers.MoE(cfg, torch.float32, "meta", None)

    def forward(self, x):
        return layers.moe_block(self.moe, self.cfg, x)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_captures_over_meta_tensors(arch):
    """Nothing in the block depends on values: it captures with make_fx over
    fake meta tensors, and the graph holds no data-dependent op."""
    _, tcfg = configs(arch)
    blk = _Block(tcfg)
    params = {n: TensorSpec(tuple(p.shape), p.dtype)
              for n, p in blk.named_parameters()}
    gm = capture_graph(
        lambda ps, x: torch.func.functional_call(blk, ps, (x,)), params,
        TensorSpec((2, 24, tcfg.d_model), torch.float32))
    names = {str(n.target) for n in gm.graph.nodes}
    for bad in ("nonzero", "_local_scalar_dense", "bincount",
                "masked_select"):
        assert not any(bad in n for n in names), bad
    assert any("topk" in n for n in names)


def test_moe_combine_gives_the_same_bits_on_every_call():
    """D36: the combine sums each token's gated rows k = 0, 1, ... in a
    fixed order, so repeated calls agree bit for bit."""
    _, tcfg, _, tp, _, tx = block_inputs("deepseek_moe_16b", "float32")
    with torch.no_grad():
        a, _ = layers.moe_block(tp, tcfg, tx)
        b, _ = layers.moe_block(tp, tcfg, tx)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the model: serving, loss, gradients, a step, convert
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=CASES,
                ids=["-".join(c) for c in CASES])
def served(request):
    """Prefill and one decode step through both packages."""
    arch, impl, dtype = request.param
    jcfg, tcfg = configs(arch, attn_impl=impl, param_dtype=dtype)
    japi, params = reference(jcfg)
    api = port(tcfg, params)
    nb = numpy_batch(jcfg, 0, seq=40, labels=False)
    j_logits, j_cache = jax.jit(japi.prefill)(params, jax_batch(nb, dtype))
    t_logits, t_cache = api.prefill(torch_batch(nb, dtype))
    tok = np.asarray(jnp.argmax(j_logits, -1))
    j_logits2, j_cache2 = jax.jit(japi.decode)(
        params, j_cache, jnp.asarray(tok, jnp.int32), jnp.int32(33))
    t_logits2, t_cache2 = api.decode(t_cache, torch.tensor(tok).long(), 33)
    return dtype, (j_logits, j_cache, j_logits2, j_cache2), \
        (t_logits, t_cache, t_logits2, t_cache2)


def test_prefill_logits_match(served):
    dtype, j, t = served
    close(t[0], j[0], dtype, "prefill logits")


def test_decode_step_logits_and_cache_match(served):
    dtype, j, t = served
    close(t[2], j[2], dtype, "decode logits")
    for cache_j, cache_t in ((j[1], t[1]), (j[3], t[3])):
        assert sorted(cache_t) == sorted(cache_j)
        for key in cache_j:
            for n, a, b in zip("kv", cache_t[key], cache_j[key]):
                cache_close(a, b, dtype, f"cache {key} {n}")


@pytest.fixture(scope="module", params=ARCHS)
def trained(request):
    arch = request.param
    jcfg, tcfg = configs(arch, param_dtype="float32")
    japi, params = reference(jcfg)
    return arch, jcfg, tcfg, japi, params


@pytest.mark.parametrize("impl", ["ref", "flash"])
def test_loss_and_every_gradient_leaf_match_reference(trained, impl):
    arch, jcfg, tcfg, _, params = trained
    jcfg = dataclasses.replace(jcfg, attn_impl=impl)
    tcfg = dataclasses.replace(tcfg, attn_impl=impl)
    nb = numpy_batch(jcfg, 1)
    loss_j, grads_j = jax.value_and_grad(jax_build(jcfg).loss)(
        params, jax_batch(nb))
    api = port(tcfg, params)
    loss_t = api.loss(torch_batch(nb))
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j),
                               rtol=TOL["float32"])
    grads_t = export_params({n: p.grad for n, p in
                             api.model.named_parameters()})
    assert_trees_close(grads_t, to_numpy(grads_j), "grad",
                       scaled=TOL["float32"])


def test_one_train_step_matches_reference(trained):
    arch, jcfg, tcfg, japi, params = trained
    nb = numpy_batch(jcfg, 2)
    jopt = jax_make_optimizer(jcfg, total_steps=1)
    jstep = jax.jit(jax_make_train_step(japi, jopt))
    jp, _, jm = jstep(params, jopt.init(params), jax_batch(nb))
    api = port(tcfg, params)
    opt = make_optimizer(api.cfg, total_steps=1)
    tp = dict(api.model.named_parameters())
    tp, _, m = make_train_step(api, opt)(tp, opt.init(tp), torch_batch(nb))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                   rtol=TOL["float32"])
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    assert_trees_close(export_params(tp), to_numpy(jp), "params",
                       atol=TOL["float32"], rtol=TOL["float32"])


def test_convert_round_trips_the_moe_tree(trained):
    arch, _, tcfg, _, params = trained
    api = port(tcfg, params)
    tree = export_params(api.model)
    assert_trees_close(tree, to_numpy(params), "export", atol=0)
    assert tree["layers"]["moe"]["router"].shape == \
        (tcfg.n_layers - tcfg.moe_first_dense, tcfg.d_model,
         tcfg.moe_experts)
    assert api.model.layers[0].moe.router.dtype == torch.float32
    if tcfg.moe_first_dense:
        assert "dense_layers" in tree and "mlp" in tree["dense_layers"]
    bad = export_params(api.model)
    del bad["layers"]["moe"]["we_up"]
    with pytest.raises(KeyError):
        load_reference_params(api.model, bad)
