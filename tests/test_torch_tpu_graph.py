"""The graph-walking backend (``tpu_graph``, alias ``tpu``) against the JAX
reference's jaxpr walk (CPU).

The two walk different graph IRs (an aten graph and a jaxpr), so a GEMM
stack whose two graphs have the same ops is the bit-level oracle: under the
reference's constants (imported, never written here) the trace's time,
address and write arrays and each op's flops, bytes, start and cycles are
equal exactly, and the composed report equals the reference's (counts and
capacities exactly, energies within 1e-9 relative) with its subpartition
``"VMEM"`` named ``"SMEM"`` and ``dot_general`` named ``mm``.  On the
models the walks agree on the trace contract and on matmul FLOPs: the sum
over the aten graph's matmuls equals the sum over the jaxpr's
``dot_general``s that contract an index, each times its scan's length.
Two op-level differences are named where they are tested: the label logit
is a gather in the port (ROADMAP D14) and a one-hot product in the
reference (neither is a matmul), and an einsum that contracts no index is
a ``dot_general`` in jax and an elementwise ``mul`` in torch.
"""

import collections
import dataclasses
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.backends import tpu_graph as R
from repro.configs.base import ShapeCell as RefShapeCell
from repro.configs.base import get_config as jax_config
from repro.core import ProfileSession as RefSession
from repro.models.api import batch_specs as ref_batch_specs
from repro.models.api import build as jax_build
from repro.workloads import get_workload as ref_get_workload
from repro_torch.backends import tpu_graph as P
from repro_torch.configs.base import ShapeCell, get_config
from repro_torch.core import ProfileSession as PortSession
from repro_torch.core import get_backend
from repro_torch.launch.steps import (abstract_params, input_specs,
                                      make_loss_fn)
from repro_torch.models.api import TensorSpec, batch_specs, build
from repro_torch.workloads import get_workload as port_get_workload

REF_CLOCK = inspect.signature(R.trace_jaxpr).parameters["clock_hz"].default
REF_CONSTANTS = {"clock_hz": REF_CLOCK, "peak_flops": R.PEAK_FLOPS,
                 "hbm_bw": R.HBM_BW}
RTOL = 1e-9
# x, w1 (320 blocks of 4 KiB: over the 64-block cap), w2, b
GEMM_SHAPES = [(64, 128), (128, 2560), (2560, 32), (64, 32)]
ARCHS = ("tinyllama_1_1b", "mamba2_130m", "zamba2_2_7b", "deepseek_moe_16b",
         "phi3_5_moe", "internvl2_1b", "whisper_small")
# the families ported after the walk: MoE, VLM and audio
LATER_FAMILIES = ("deepseek_moe_16b", "phi3_5_moe", "internvl2_1b",
                  "whisper_small")
SSM_ARCHS = ("mamba2_130m", "zamba2_2_7b")
STACKED = ("layers", "dense_layers", "enc_layers", "dec_layers")


def ref_stack(x, w1, w2, b):
    return jnp.tanh(x @ w1) @ w2 + b


def port_stack(x, w1, w2, b):
    return torch.tanh(x @ w1) @ w2 + b


def gemm_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in GEMM_SHAPES]


def ref_name(name):
    return "mm" if name == "dot_general" else name


def port_report_key(name):
    return "SMEM" if name == "VMEM" else name


def assert_reports_equal(got, want, path="report"):
    """Ints, bools, strings and capacity fractions exactly; floats to
    RTOL; the reference's VMEM/dot_general are SMEM/mm here."""
    if isinstance(want, dict):
        want = {port_report_key(k): v for k, v in want.items()}
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            if k in ("capacity_fractions", "unquantized_fractions"):
                assert got[k] == want[k], f"{path}.{k}"
            elif k == "name":
                assert got[k] == ref_name(want[k]), f"{path}.{k}"
            else:
                assert_reports_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_reports_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float), path
        if math.isfinite(want):
            assert got == pytest.approx(want, rel=RTOL, abs=0.0), path
        else:
            assert got == want or (math.isnan(got) and math.isnan(want)), \
                path
    else:
        assert type(got) is type(want) and got == want, path


# ---------------------------------------------------------------------------
# the GEMM stack: event for event
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sample", [1, 4])
def test_gemm_stack_trace_equals_the_jaxpr_walk(sample):
    arrays = gemm_inputs()
    want, want_ops = R.trace_jaxpr(ref_stack, *map(jnp.asarray, arrays),
                                   sample=sample)
    got, got_ops = P.trace_graph(port_stack,
                                 *map(torch.from_numpy, arrays),
                                 sample=sample, **REF_CONSTANTS)
    assert want.n_events > 0
    for f in ("time_cycles", "addr", "is_write", "hit", "subpartition"):
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert (got.clock_hz, got.block_bits) == (want.clock_hz,
                                              want.block_bits)
    assert want.names == ("VMEM",) and got.names == ("SMEM",)
    assert [(o.name, o.flops, o.bytes_touched, o.start_cycle, o.cycles)
            for o in got_ops] == \
        [(ref_name(o.name), o.flops, o.bytes_touched, o.start_cycle,
          o.cycles) for o in want_ops]
    assert [o.name for o in got_ops] == ["mm", "tanh", "mm", "add"]
    if sample == 1:
        # one block range per buffer, each capped at 64 blocks (w1 has 320)
        sizes = [a.nbytes for a in arrays] + [64 * 2560 * 4] * 2 + \
            [64 * 32 * 4] * 2
        assert np.unique(np.asarray(got.addr)).size == sum(
            min(64, math.ceil(b / P.BLOCK_BYTES)) for b in sizes)


@pytest.mark.parametrize("engine", ["numpy", "torch"])
@pytest.mark.parametrize("policy", ["refresh-free", "refresh-aware"])
def test_gemm_stack_report_equals_reference(policy, engine):
    arrays = gemm_inputs(1)
    want = RefSession("tpu").run(
        (ref_stack, *(jax.ShapeDtypeStruct(a.shape, jnp.float32)
                      for a in arrays)), policy=policy, engine="numpy")
    got = PortSession("tpu", device="cpu").run(
        (port_stack, *(TensorSpec(a.shape, torch.float32) for a in arrays)),
        policy=policy, engine=engine, **REF_CONSTANTS)
    assert got["n_ops"] == want["n_ops"] == 4
    assert_reports_equal(got, want)


def test_chunked_run_folds_to_the_monolithic_report():
    arrays = [torch.from_numpy(a) for a in gemm_inputs()]
    mono = PortSession("tpu", device="cpu").run(
        (port_stack, *arrays), engine="numpy")
    res = get_backend("tpu").run((port_stack, *arrays), chunk_events=100)
    assert res.streaming
    stream = PortSession.from_chunks(res.chunks, device="cpu").report()
    m, s = mono["subpartitions"]["SMEM"], stream["subpartitions"]["SMEM"]
    for key in ("n_reads", "n_writes", "n_lifetimes"):
        assert m[key] == s[key]


def test_views_are_their_inputs_buffers():
    """``F.linear`` is ``t`` + ``mm`` in the aten graph; the transpose and
    the reshapes of a 3-D product cost nothing and emit nothing, so the
    trace equals the one of the plain 2-D product on the same buffers."""
    x, w = TensorSpec((64, 96), torch.float32), \
        TensorSpec((48, 96), torch.float32)
    tr, ops = P.trace_graph(lambda a, b: F.linear(a, b), x, w)
    assert [o.name for o in ops] == ["mm"]
    assert ops[0].flops == 2.0 * 64 * 48 * 96
    x3 = TensorSpec((2, 32, 96), torch.float32)
    tr3, ops3 = P.trace_graph(lambda a, b: F.linear(a, b), x3, w)
    assert [o.name for o in ops3] == ["mm"]
    for f in ("time_cycles", "addr", "is_write"):
        np.testing.assert_array_equal(getattr(tr3, f), getattr(tr, f))
    # an in-place op costs as any op and writes the buffer it mutates
    tr_i, ops_i = P.trace_graph(lambda a: a.mul_(2.0).sum(),
                                TensorSpec((64, 64), torch.float32))
    assert [o.name for o in ops_i] == ["mul_", "sum"]


# ---------------------------------------------------------------------------
# the framework's own models
# ---------------------------------------------------------------------------

def port_walk(arch, seq=32, smoke=True, **kw):
    cfg = get_config(arch, smoke=smoke)
    api = build(cfg, device="meta")
    return P.trace_graph(make_loss_fn(api), abstract_params(api),
                         batch_specs(cfg, ShapeCell("t", "train", seq, 1)),
                         **kw)


def ref_jaxpr(arch, seq=32):
    cfg = jax_config(arch, smoke=True)
    api = jax_build(cfg)
    params = jax.eval_shape(lambda k: api.init(k)[0], jax.random.PRNGKey(0))
    bspec = ref_batch_specs(cfg, RefShapeCell("t", "train", seq, 1))
    return jax.make_jaxpr(api.loss)(params, bspec).jaxpr


def ref_dot_generals(jx, mult=1.0, out=None):
    """(flops x multiplicity, contracts an index) of every dot_general,
    recursing into every sub-jaxpr.  The reference's own walk stops at
    ``jit`` eqns on this jax, which renamed ``pjit`` (ROADMAP F7), so the
    test walks the jaxpr itself with the reference's ``_eqn_flops``."""
    out = [] if out is None else out
    for eqn in jx.eqns:
        if eqn.primitive.name == "scan":
            ref_dot_generals(eqn.params["jaxpr"].jaxpr,
                             mult * eqn.params["length"], out)
            continue
        inner = eqn.params.get("jaxpr") or eqn.params.get("call_jaxpr")
        if inner is not None:
            ref_dot_generals(getattr(inner, "jaxpr", inner), mult, out)
        elif eqn.primitive.name == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            out.append((R._eqn_flops(eqn) * mult, bool(lc)))
    return out


def assert_trace_contract(trace):
    t = np.asarray(trace.time_cycles)
    a = np.asarray(trace.addr)
    w = np.asarray(trace.is_write)
    assert trace.names == ("SMEM",)
    assert np.all(np.diff(t) >= 0)
    assert w.any() and (~w).any()
    # the first event at every block is a write
    _, first = np.unique(a, return_index=True)
    assert w[first].all()


@pytest.mark.parametrize("arch", ARCHS)
def test_model_walk_keeps_the_trace_contract(arch):
    for sample in (1, 4):
        trace, ops = port_walk(arch, sample=sample)
        assert_trace_contract(trace)
        assert len(ops) > 10
        assert all(o.cycles >= 1 for o in ops)
        starts = [o.start_cycle for o in ops]
        assert starts == sorted(starts)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_walk_matmul_flops_equal_the_reference(arch):
    _, ops = port_walk(arch)
    port = sum(o.flops for o in ops if o.name in P._MATMULS)
    dots = ref_dot_generals(ref_jaxpr(arch))
    assert port == sum(f for f, contracts in dots if contracts)
    # F7: the reference's own walk counts no more than the jaxpr holds
    cfg = jax_config(arch, smoke=True)
    api = jax_build(cfg)
    _, ref_ops = R.trace_jaxpr(
        api.loss, jax.eval_shape(lambda k: api.init(k)[0],
                                 jax.random.PRNGKey(0)),
        ref_batch_specs(cfg, RefShapeCell("t", "train", 32, 1)))
    assert sum(o.flops for o in ref_ops if o.name == "dot_general") <= \
        sum(f for f, _ in dots)
    uncontracted = sum(f for f, contracts in dots if not contracts)
    if arch in SSM_ARCHS:
        # the SSD form's einsums over no index: a mul in torch
        assert uncontracted > 0
    else:
        assert uncontracted == 0
    # D14: the port gathers the label logit; the reference multiplies by a
    # one-hot and sums: no matmul on either side
    names = collections.Counter(o.name for o in ops)
    assert names["gather"] == 1


def test_model_walk_allocates_nothing():
    """The capture runs over meta tensors: the graph's values all live on
    the meta device."""
    cfg = get_config("tinyllama_1_1b", smoke=True)
    api = build(cfg, device="meta")
    gm = P.capture_graph(make_loss_fn(api), abstract_params(api),
                         batch_specs(cfg, ShapeCell("t", "train", 16, 1)))
    vals = [n.meta["val"] for n in gm.graph.nodes
            if isinstance(n.meta.get("val"), torch.Tensor)]
    assert vals and all(v.device.type == "meta" for v in vals)
    # no autograd nodes: the capture runs under no_grad
    assert not any("detach" in str(n.target) for n in gm.graph.nodes)


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_route_cannot_be_captured(arch):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              attn_impl="flash")
    api = build(cfg, device="meta")
    with pytest.raises(ValueError, match="attn_impl='ref'"):
        P.trace_graph(make_loss_fn(api), abstract_params(api),
                      batch_specs(cfg, ShapeCell("t", "train", 64, 1)))


def test_build_on_meta_draws_nothing():
    state = torch.random.get_rng_state()
    for arch in ARCHS:
        api = build(get_config(arch, smoke=False), device="meta")
        assert all(p.device.type == "meta" for p in api.model.parameters())
    assert torch.equal(torch.random.get_rng_state(), state)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_input_specs_equal_the_reference(arch):
    cfg = jax_config(arch, smoke=False)
    api = jax_build(cfg)
    ref = jax.eval_shape(lambda k: api.init(k)[0], jax.random.PRNGKey(0))
    port = abstract_params(build(get_config(arch, smoke=False),
                                 device="meta"))
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        keys = [p.key for p in path]
        if keys[0] in STACKED:
            for i in range(leaf.shape[0]):
                want[".".join([keys[0], str(i), *keys[1:]])] = \
                    (leaf.shape[1:], str(leaf.dtype))
        else:
            want[".".join(keys)] = (leaf.shape, str(leaf.dtype))
    assert {n: (s.shape, str(s.dtype).split(".")[-1])
            for n, s in port.items()} == want
    assert sum(math.prod(s.shape) for s in port.values()) == \
        sum(math.prod(x.shape) for x in jax.tree.leaves(ref))
    from repro.configs.base import SHAPES, shape_applicable
    from repro.launch.steps import input_specs as ref_input_specs
    for shape_name, shape in SHAPES.items():
        if not shape_applicable(cfg, shape):   # a cell the dry-run skips
            continue
        specs = input_specs(arch, shape_name)
        ref_specs = ref_input_specs(arch, shape_name)
        assert jax.tree.map(lambda v: tuple(v.shape), specs,
                            is_leaf=lambda v: hasattr(v, "shape")) == \
            jax.tree.map(lambda v: tuple(v.shape), ref_specs), shape_name


# ---------------------------------------------------------------------------
# registry, lowering, CLI
# ---------------------------------------------------------------------------

def test_registry_resolves_both_names():
    from repro_torch.core import available_backends
    assert get_backend("tpu").name == get_backend("tpu_graph").name == \
        "tpu_graph"
    assert get_backend("tpu").mode == "scratchpad"
    assert "tpu_graph" in available_backends()
    with pytest.raises(TypeError, match="callable"):
        get_backend("tpu").run(42)


@pytest.mark.parametrize("arch", LATER_FAMILIES)
def test_unported_families_plan_but_raise_naming_a9(arch):
    """Named when these families still raised naming A9: since the MoE, VLM
    and audio families were ported their ``tpu`` lowering builds, as the
    reference's does, and walks their training step."""
    spec = port_get_workload(arch)
    assert spec.supports("tpu") and ref_get_workload(arch).supports("tpu")
    (fn, params, batch), cfg = spec.build("tpu")
    (_, ref_params, ref_batch), ref_cfg = ref_get_workload(arch).build("tpu")
    assert cfg == ref_cfg == {"sample": 4}
    assert sorted(batch) == sorted(ref_batch)
    assert {k: tuple(v.shape) for k, v in batch.items()} == \
        {k: tuple(v.shape) for k, v in ref_batch.items()}
    assert sum(math.prod(p.shape) for p in params.values()) == sum(
        math.prod(x.shape) for x in jax.tree.leaves(ref_params))
    trace, ops = P.trace_graph(fn, params, batch, **cfg)
    assert_trace_contract(trace)


def test_arch_lowering_uses_the_smoke_config_unless_told():
    spec = port_get_workload("tinyllama_1_1b").with_params(seq=16)
    (fn, params, batch), cfg = spec.build("tpu_graph")
    assert cfg == {"sample": 4}
    assert batch["tokens"] == TensorSpec((1, 16), torch.int64)
    smoke = get_config("tinyllama_1_1b", smoke=True)
    assert params["embed"].shape == (smoke.vocab, smoke.d_model)
    (_, full, _), _ = spec.with_params(tpu_smoke=False).build("tpu")
    assert len(full) > len(params)


def test_cli_dry_run_and_arch(capsys, tmp_path):
    from repro_torch.launch.profile import main
    report = main(["--backend", "tpu", "--dry-run", "--device", "cpu"])
    assert "dry-run ok: backend=tpu_graph subpartitions=['SMEM']" in \
        capsys.readouterr().out
    assert report["n_ops"] == 2
    out = tmp_path / "r.json"
    report = main(["--arch", "tinyllama_1_1b", "--backend", "tpu",
                   "--smoke", "--seq", "16", "--device", "cpu",
                   "--engine", "numpy", "--chunk-events", "100",
                   "--out", str(out)])
    assert out.exists() and report["subpartitions"]["SMEM"]["n_reads"] > 0
    full = main(["--arch", "mamba2_130m", "--backend", "tpu_graph",
                 "--full", "--seq", "16", "--device", "cpu",
                 "--engine", "numpy"])
    assert full["n_ops"] > report["n_ops"]


def test_profile_tpu_and_sweep_cli(capsys):
    from repro_torch.launch.profile import profile_tpu
    from repro_torch.launch.sweep import main as sweep_main
    report = profile_tpu(get_config("mamba2_130m", smoke=True), 16, None,
                         device="cpu")
    assert "composition" in report["subpartitions"]["SMEM"]
    result = sweep_main(["--backend", "tpu", "--arch", "mamba2_130m",
                         "--seq", "16", "--device", "cpu"])
    assert len(result) > 0
    assert "sweep ok" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        sweep_main(["--backend", "tpu", "--dry-run", "--device", "cpu"])
