"""The port's operator address streams equal the reference's (CPU).

``repro_torch.backends.opstream`` is numpy, as the reference's is: the same
op programs on the same ``sample`` must give bit-equal ``(time_cycles,
byte_addr, is_write)`` streams and equal per-kernel counters, and the
``opstream`` backend the same trace.
"""

import dataclasses

import numpy as np
import pytest

from repro.backends import opstream as ref
from repro_torch.backends import opstream as port

PROGRAMS = {
    "dense": lambda m, sb: m.transformer_ops(
        sb, d_model=256, n_heads=4, kv_heads=4, d_ff=512, seq=32,
        n_layers=2),
    "gqa": lambda m, sb: m.transformer_ops(
        sb, d_model=256, n_heads=8, kv_heads=2, d_ff=640, seq=48,
        n_layers=1, dtype_bytes=4),
    "moe": lambda m, sb: m.transformer_ops(
        sb, d_model=128, n_heads=4, kv_heads=2, d_ff=256, seq=32,
        n_layers=2, moe_experts=8, moe_topk=2),
    "moe_few_experts": lambda m, sb: m.transformer_ops(
        sb, d_model=128, n_heads=4, kv_heads=4, d_ff=256, seq=16,
        n_layers=1, moe_experts=3, moe_topk=1),
    "resnet": lambda m, sb: m.resnet_ops(
        sb, [(14, 32, 16, 3), (7, 64, 32, 1), (7, 64, 64, 3)]),
    "conv2d": lambda m, sb: m.polybench_conv_ops(sb, dim=2, n=64),
    "conv3d": lambda m, sb: m.polybench_conv_ops(sb, dim=3, n=16),
}


def streams(program, sample):
    out = []
    for mod in (ref, port):
        sb = mod.StreamBuilder(sample=sample)
        PROGRAMS[program](mod, sb)
        out.append((sb.finish(), [dataclasses.asdict(k)
                                  for k in sb.kernels]))
    return out


@pytest.mark.parametrize("sample", [1, 8, 32])
@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_streams_and_kernels_bit_equal(program, sample):
    (want, k_want), (got, k_got) = streams(program, sample)
    for name, g, w in zip(("time_cycles", "byte_addr", "is_write"), got,
                          want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert k_got == k_want
    assert len(got[0]) > 0 and (np.diff(got[0]) >= 0).all()


@pytest.mark.parametrize("sample", [2, 8, 32, 1000])
def test_line_sampling_hash_equal(sample):
    rng = np.random.RandomState(sample)
    lines = np.concatenate([np.arange(5000, dtype=np.int64),
                            rng.randint(0, 2 ** 62, 5000).astype(np.int64)])
    kept = port.StreamBuilder(sample=sample)._keep(lines)
    np.testing.assert_array_equal(
        kept, ref.StreamBuilder(sample=sample)._keep(lines))
    assert 0 < len(kept) < len(lines)


def test_allocator_and_empty_builder_equal():
    for mod in (ref, port):
        t, a, w = mod.StreamBuilder().finish()
        assert t.dtype == a.dtype == np.int64 and w.dtype == bool
        assert len(t) == 0
    refs = []
    for mod in (ref, port):
        sb = mod.StreamBuilder()
        x = sb.alloc("x", 1000)
        got = [x, sb.alloc_weight("w", 300)]
        sb.free(x)
        got += [sb.alloc("y", 500),       # first fit into the freed block
                sb.alloc("z", 5000), sb.alloc("q", 1)]
        refs.append([(r.base, r.nbytes, r.n_lines) for r in got]
                    + [(sb._act_base, sb._weight_base, len(sb._free))])
    assert refs[0] == refs[1]


@pytest.mark.parametrize("program", ["dense", "moe", "conv2d"])
def test_opstream_backend_trace_equal(program):
    from repro_torch.core.api import get_backend as port_backend
    from repro.core.api import get_backend as ref_backend
    fn = {"ref": lambda sb: PROGRAMS[program](ref, sb),
          "port": lambda sb: PROGRAMS[program](port, sb)}
    want = ref_backend("opstream").run(fn["ref"], sample=4)
    got = port_backend("opstream").run(fn["port"], sample=4)
    assert got.mode == want.mode == "scratchpad"
    for f in ("time_cycles", "addr", "is_write", "hit", "subpartition"):
        np.testing.assert_array_equal(getattr(got.trace, f),
                                      getattr(want.trace, f), err_msg=f)
    assert got.trace.names == want.trace.names == ("stream",)
    assert got.kernels == want.kernels
    chunks = list(port_backend("opstream").run(
        fn["port"], sample=4, chunk_events=1000).chunks)
    np.testing.assert_array_equal(
        np.concatenate([c.addr for c in chunks]), want.trace.addr)
    with pytest.raises(TypeError, match="StreamBuilder"):
        port_backend("opstream").run((np.zeros(1), np.zeros(1),
                                      np.zeros(1, bool)))
