"""``launch/roofline.py`` against the JAX reference's (CPU).

``roofline_terms`` and ``model_flops`` are the reference's arithmetic:
with the reference's TPU constants passed they are bit-equal to it.  The
recorded per-device matmul FLOPs of a smoke loss with no mesh equal the
reference's ``hlo_cost`` of the compiled loss exactly (the port's graph is
unrolled, so its matmul sites are executions, not loop bodies: ROADMAP
D33), and with no mesh no collective moves a byte.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS, SHAPES
from repro.configs.base import ShapeCell as RefShapeCell
from repro.configs.base import get_config as jax_config
from repro.configs.base import shape_applicable as ref_applicable
from repro.launch import roofline as R
from repro.models.api import build as jax_build
from repro_torch.backends import tpu_graph
from repro_torch.configs.base import ShapeCell, get_config, shape_applicable
from repro_torch.launch import roofline as P
from repro_torch.models.api import batch_specs, build

REF_CONSTANTS = {"peak_flops": R.PEAK_FLOPS, "hbm_bw": R.HBM_BW,
                 "link_bw": R.ICI_BW}
LOSS_ARCHS = ("tinyllama_1_1b", "zamba2_2_7b", "whisper_small")


@pytest.mark.parametrize("per_device", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_roofline_terms_equal_the_reference_bit_for_bit(seed, per_device):
    rng = np.random.RandomState(seed)
    for _ in range(200):
        flops, nbytes, coll = (float(v) for v in
                               10.0 ** rng.uniform(0, 18, size=3))
        if rng.rand() < 0.1:
            coll = 0.0
        chips = int(rng.choice([1, 4, 256, 512]))
        want = R.roofline_terms(flops, nbytes, coll, chips, per_device)
        got = P.roofline_terms(flops, nbytes, coll, chips, per_device,
                               **REF_CONSTANTS)
        assert got == want
    zero = P.roofline_terms(0.0, 0.0, 0.0, 1, **REF_CONSTANTS)
    assert zero == R.roofline_terms(0.0, 0.0, 0.0, 1)


def test_h100_constants_have_one_definition():
    assert P.PEAK_FLOPS is tpu_graph.PEAK_FLOPS == 989e12
    assert P.HBM_BW is tpu_graph.HBM_BW == 3.35e12
    assert P.LINK_BW == 450e9
    terms = P.roofline_terms(989e12, 3.35e12, 450e9, 1)
    assert terms["compute_s"] == terms["memory_s"] == \
        terms["collective_s"] == 1.0


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_applicability_equal_the_reference(arch,
                                                           shape_name):
    ref = R.model_flops(jax_config(arch), SHAPES[shape_name])
    cfg = get_config(arch)
    from repro_torch.configs.base import SHAPES as PORT_SHAPES
    shape = PORT_SHAPES[shape_name]
    assert P.model_flops(cfg, shape) == ref
    assert shape_applicable(cfg, shape) == \
        ref_applicable(jax_config(arch), SHAPES[shape_name])


def test_collective_kinds_are_the_references():
    assert P.COLLECTIVES == R._COLLECTIVES
    assert set(P._COLLECTIVE_KIND.values()) == set(R._COLLECTIVES)


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_smoke_loss_dot_flops_equal_the_reference_hlo_cost(arch):
    cfg = jax_config(arch, smoke=True)
    api = jax_build(cfg)
    params, _ = api.init(jax.random.PRNGKey(0))
    batch = api.make_batch(jax.random.PRNGKey(1),
                           RefShapeCell("t", "train", 64, 2))
    text = jax.jit(api.loss).lower(params, batch).compile().as_text()
    ref = R.hlo_cost(text)

    port_api = build(get_config(arch, smoke=True), device="meta")
    specs = batch_specs(port_api.cfg, ShapeCell("t", "train", 64, 2))
    meta = {k: torch.empty(s.shape, dtype=s.dtype, device="meta")
            for k, s in specs.items()}
    rec = P.StepRecorder()
    with torch.no_grad(), rec:
        loss = port_api.loss(meta)
    got = P.hlo_cost(rec)
    assert loss.shape == ()
    assert got["dot_flops"] == ref["dot_flops"]
    assert got["n_dot_sites"] >= ref["n_dot_sites"] > 0
    assert got["multiplicities"] == {}
    assert got["bytes"] > 0 and rec.peak > 0
    assert R.collective_bytes(text).total_bytes == 0
    coll = P.collective_bytes(rec)
    assert coll.total_bytes == 0 and coll.count == 0
    assert set(coll.by_kind) == set(R._COLLECTIVES)


def test_recorder_counts_views_free_and_in_place_updates_once():
    a = torch.empty((64, 32), device="meta")
    b = torch.empty((32, 16), device="meta")
    rec = P.StepRecorder()
    with rec:
        c = a @ b                  # 2 * 64 * 16 * 32 flops, 4 KiB out
        ct = c.t()                 # a view: free
        c.add_(1.0)                # in place: out + operands - buffer
        d = torch.empty((8,), device="meta")     # no traffic
    assert rec.dot_flops == 2 * 64 * 16 * 32 and rec.n_dot_sites == 1
    out_b = 64 * 16 * 4
    assert rec.bytes == 2 * out_b + out_b
    assert rec.peak == out_b + 8 * 4
    assert ct.shape == (16, 64) and d.shape == (8,)
    del c, ct, d
    assert rec.live == 0


def test_local_and_aliased_bytes():
    x = torch.empty((4, 8), dtype=torch.bfloat16, device="meta")
    y = torch.empty((2,), dtype=torch.float32, device="meta")
    tree = {"x": x, "pair": (y, 3)}
    assert P.local_bytes(tree) == 4 * 8 * 2 + 2 * 4
    assert P.aliased_bytes({"same": x, "new": y.clone()}, tree) == 64
    assert P.aliased_bytes((x[1:],), {"x": x}) == 3 * 8 * 2
