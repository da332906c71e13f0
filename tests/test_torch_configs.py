"""The port's architecture configs against the JAX reference (CPU).

Every config module is a pure dataclass (``CONFIG`` and ``SMOKE``); the
port has all ten of the reference's, in its order, and each registers an
``archs`` workload whose systolic GEMM list and op-stream program equal the
reference's.  Every registered spec, the ``archs`` ones with their
``tpu_graph`` lowering and ``tpu_smoke`` param included, hashes as the
reference's.  Nothing here builds a model (the families are held against
the reference in ``tests/test_torch_moe.py``, ``test_torch_vlm_audio.py``
and the other model tests).
"""

import dataclasses
import importlib

import numpy as np
import pytest

from repro.backends.opstream import StreamBuilder as RefBuilder
from repro.configs.base import ARCH_IDS as REF_ARCH_IDS
from repro.workloads import available_workloads as ref_available_workloads
from repro.workloads import get_workload as ref_get_workload
from repro_torch.backends.opstream import StreamBuilder as PortBuilder
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.workloads import available_workloads
from repro_torch.workloads import get_workload as port_get_workload

# the configs this slice adds; the other three came with the models
NEW_ARCHS = ("deepseek_67b", "chatglm3_6b", "qwen1_5_32b", "phi3_5_moe",
             "deepseek_moe_16b", "internvl2_1b", "whisper_small")


def test_arch_ids_equal_the_reference():
    assert ARCH_IDS == REF_ARCH_IDS
    assert len(ARCH_IDS) == 10
    assert set(NEW_ARCHS) < set(ARCH_IDS)


@pytest.mark.parametrize("arch", REF_ARCH_IDS)
@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_config_dataclasses_equal_the_reference(arch, which):
    ref = getattr(importlib.import_module(f"repro.configs.{arch}"), which)
    port = getattr(importlib.import_module(f"repro_torch.configs.{arch}"),
                   which)
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert get_config(arch, smoke=which == "SMOKE") is port


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_arch_lowerings_equal_the_reference(arch):
    """At seq 32: the systolic GEMM list layer for layer, and the
    cachesim op stream with its per-kernel counters and run kwargs."""
    ref_spec = ref_get_workload(arch).with_params(seq=32)
    port_spec = port_get_workload(arch).with_params(seq=32)
    assert port_spec.suite == ref_spec.suite == "archs"
    assert port_spec.backends == ref_spec.backends
    assert "tpu_graph" in port_spec.backends
    assert port_spec.params == ref_spec.params
    assert port_spec.content_hash() == ref_spec.content_hash()

    (gemms_r, cfg_r), (gemms_p, cfg_p) = (ref_spec.build("systolic"),
                                          port_spec.build("systolic"))
    assert cfg_p == cfg_r
    assert [dataclasses.asdict(g) for g in gemms_p] == \
        [dataclasses.asdict(g) for g in gemms_r]
    assert gemms_p

    (prog_r, cfg_r), (prog_p, cfg_p) = (ref_spec.build("cachesim"),
                                        port_spec.build("cachesim"))
    assert cfg_p == cfg_r
    sb_r, sb_p = RefBuilder(**cfg_r), PortBuilder(**cfg_p)
    prog_r(sb_r)
    prog_p(sb_p)
    for g, w in zip(sb_p.finish(), sb_r.finish(), strict=True):
        np.testing.assert_array_equal(g, w)
    assert [k.__dict__ for k in sb_p.kernels] == \
        [k.__dict__ for k in sb_r.kernels]


@pytest.mark.parametrize("name", ref_available_workloads())
def test_every_registered_spec_hashes_as_the_reference(name):
    """Name, suite, version, params, backends and ``content_hash()``: the
    campaign cache key's workload half is the reference's for every
    registered workload."""
    assert available_workloads() == ref_available_workloads()
    ref, port = ref_get_workload(name), port_get_workload(name)
    assert (port.name, port.suite, port.version, port.params,
            port.backends, port.description) == \
        (ref.name, ref.suite, ref.version, ref.params, ref.backends,
         ref.description)
    assert port.content_hash() == ref.content_hash()
