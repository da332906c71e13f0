"""The port's sharding rules against the JAX reference, in one process and
without a process group: ``choose_mesh_shape``, ``resolve`` (templates to
DTensor placements, read back as {tensor dim: mesh axes}), the parameter
templates of every family, the batch, cache and decode-input templates,
and the production mesh's world-size check.  Every comparison is exact.
The multi-rank runs are ``tests/test_torch_distributed.py``'s.
"""

import dataclasses

import jax
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro.configs.base import ARCH_IDS, ShapeCell
from repro.configs.base import get_config as jax_config
from repro.distributed import sharding as jax_shd
from repro.launch.steps import decode_input_specs as jax_decode_input_specs
from repro.models.api import batch_shardings as jax_batch_shardings
from repro.models.api import build as jax_build
from repro.runtime.elastic import choose_mesh_shape as jax_choose
from repro_torch.configs.base import get_config
from repro_torch.convert import STACKED
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (cache_specs_templates,
                                      decode_input_specs, make_meta_cache)
from repro_torch.models import mamba2
from repro_torch.models.api import batch_shardings, build, param_templates
from repro_torch.runtime import choose_mesh_shape


@pytest.fixture(autouse=True)
def no_mesh():
    shd.set_mesh(None)
    jax_shd.set_mesh(None)
    yield
    shd.set_mesh(None)
    jax_shd.set_mesh(None)
    assert not dist.is_initialized()


def _is_template(t):
    return isinstance(t, tuple) and all(
        x is None or isinstance(x, (str, tuple)) for x in t)


def _spec_leaves(tree, prefix=()):
    """{path: template} of a reference spec tree (nested dicts)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_spec_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _ref_specs(arch, **kw):
    cfg = dataclasses.replace(jax_config(arch, smoke=True), **kw)
    box = {}

    def init(k):
        p, s = jax_build(cfg).init(k)
        box["s"] = s
        return p
    jax.eval_shape(init, jax.random.PRNGKey(0))
    return box["s"]


@pytest.mark.parametrize("preferred", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("multi_pod_size", [None, 256])
def test_choose_mesh_shape_equals_reference(preferred, multi_pod_size):
    for n in range(1, 1025):
        assert choose_mesh_shape(n, preferred, multi_pod_size) == \
            jax_choose(n, preferred, multi_pod_size), n


def _ref_axes(spec):
    """{tensor dim: mesh axes} of a reference PartitionSpec."""
    out = {}
    for d, e in enumerate(spec):
        if e is not None:
            out[d] = e if isinstance(e, tuple) else (e,)
    return out


def _port_axes(placements):
    names = shd.axis_names()
    out = {}
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            out.setdefault(pl.dim, ())
            out[pl.dim] += (names[i],)
        else:
            assert pl == Replicate()
    return out


@pytest.fixture(scope="module")
def all_templates():
    seen = set()
    for arch in ARCH_IDS:
        for local in (False, True):
            for t in _spec_leaves(_ref_specs(
                    arch, moe_local_dispatch=local)).values():
                seen.add(t)
    seen |= {("BATCH", None, "MODEL", None), ("MODEL", None, None),
             (("BATCH", "MODEL"), None), ("SEQ",), ()}
    return sorted(seen, key=repr)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("fsdp", [False, True])
def test_resolve_agrees_with_reference(all_templates, multi_pod, fsdp):
    jax_shd.set_mesh(None, multi_pod=multi_pod, fsdp=fsdp)
    shd.set_mesh(None, multi_pod=multi_pod, fsdp=fsdp)
    assert len(all_templates) > 10
    for t in all_templates:
        want = _ref_axes(jax_shd.resolve(t))
        got = _port_axes(shd.resolve(t))
        assert got == want, t
    assert shd.axis_names() == (("pod", "data", "model") if multi_pod
                                else ("data", "model"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_templates_equal_reference_specs(arch):
    kws = [{}]
    if jax_config(arch, smoke=True).moe_experts:
        kws.append({"moe_local_dispatch": True})
    for kw in kws:
        ref = _spec_leaves(_ref_specs(arch, **kw))
        cfg = dataclasses.replace(get_config(arch, smoke=True), **kw)
        got = param_templates(build(cfg, device="meta"))
        want, used = {}, set()
        for name in got:
            parts = tuple(name.split("."))
            if parts[0] in STACKED:
                key = (parts[0],) + parts[2:]
                want[name] = ref[key][1:]     # the layer axis dropped
            else:
                key = parts
                want[name] = ref[key]
            used.add(key)
        assert used == set(ref)
        assert got == want


@pytest.mark.parametrize("family_arch", ["tinyllama_1_1b", "internvl2_1b",
                                         "whisper_small", "mamba2_130m"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_batch_shardings_equal_reference(family_arch, kind):
    shape = ShapeCell("c", kind, 64, 2)
    assert batch_shardings(get_config(family_arch, smoke=True), shape) == \
        jax_batch_shardings(jax_config(family_arch, smoke=True), shape)


def _flat(tree, prefix=()):
    if hasattr(tree, "shape"):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = tree.items()
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat(v, prefix + (str(k),)))
    return out


def _flat_templates(tree, prefix=()):
    if _is_template(tree) and not (tree and isinstance(tree[0], tuple)
                                   and all(_is_template(x) for x in tree)):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat_templates(v, prefix + (str(k),)))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("batch", [1, 2])
def test_decode_input_specs_and_cache_templates_equal_reference(arch, batch):
    shape = ShapeCell("d", "decode", 48, batch)
    (jc, jt, ji), (jct, jtt, jit) = jax_decode_input_specs(
        jax_build(jax_config(arch, smoke=True)), shape)
    (pc, pt, pi), (pct, ptt, pit) = decode_input_specs(
        build(get_config(arch, smoke=True), device="meta"), shape)
    want = {k: tuple(v.shape) for k, v in _flat(jc).items()}
    assert {k: tuple(v.shape) for k, v in _flat(pc).items()} == want
    for k, v in _flat(pc).items():
        assert str(v.dtype).split(".")[-1] == str(_flat(jc)[k].dtype)
    assert _flat_templates(pct) == _flat_templates(jct)
    assert (pt.shape, pi.shape) == (jt.shape, ji.shape)
    assert (pt.dtype, pi.dtype) == (torch.int64, torch.int64)
    assert (ptt, pit) == (jtt, jit)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_caches_are_placed_by_the_decode_specs_templates(arch, monkeypatch):
    """One rule for a cache's sharding: every leaf a family's cache
    constructor places gets the template ``cache_specs_templates`` gives
    it, but the SSM state, which the constructor splits by batch only
    (``mamba2.SSM_STATE_TEMPLATE``, ROADMAP D51) where the reference's
    rule by rank also splits its dim 3 over MODEL.  Whisper's cross k/v
    are projections of the encoder output and take its placements; the
    specs' sequence sharding for a batch of one (``shard_seq``) is for a
    dry-run's inputs, which no constructor makes."""
    placed = {}
    real = shd.place

    def record(x, template):
        placed[id(x)] = template
        return real(x, template)
    monkeypatch.setattr(shd, "place", record)
    api = build(get_config(arch, smoke=True), device="meta")
    cache = make_meta_cache(api, 2, 48)
    want = _flat_templates(cache_specs_templates(api.cfg, cache))
    leaves = _flat(cache)
    assert set(want) == set(leaves)
    unplaced = {k[-1] for k, v in leaves.items() if id(v) not in placed}
    assert unplaced == ({"cross_k", "cross_v"} if arch == "whisper_small"
                        else set())
    for k, v in leaves.items():
        if k[-1] == "ssm":
            assert want[k] == (None, "BATCH", None, "MODEL", None)
            assert placed[id(v)] == mamba2.SSM_STATE_TEMPLATE
        elif id(v) in placed:
            assert placed[id(v)] == want[k], k


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_raises_on_a_world_of_one(multi_pod):
    with pytest.raises(RuntimeError, match="needs (256|512) processes"):
        make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    assert not dist.is_initialized()


def test_every_function_is_a_no_op_without_a_mesh():
    x = torch.ones(4, 6)
    assert shd.constrain(x, ("BATCH", "MODEL")) is x
    assert shd.place(x, ("BATCH", None)) is x
    assert shd.named_sharding(("BATCH",)) is None
    assert shd.fitted_sharding((4,), ("BATCH",)) is None
    assert shd.tree_shardings({"a": ("BATCH",)}) is None
    assert shd.tree_shardings_for({"a": x}, {"a": ("BATCH", None)}) is None
    assert shd.replicated() is None
    assert shd.axis_size("model") == 1
