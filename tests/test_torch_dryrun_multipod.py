"""``launch/dryrun.py`` on the 2x16x16 production mesh (CPU): each
family's smoke config at small shapes over a fake world of 512 ranks held
in this one process (``compat.fake_world``), with meta DTensors.  The
16x16 cells and the rest of the dry-run's tests are in
``tests/test_torch_dryrun.py``; the two files share
``tests/dryrun_cells.py``.

The multi-pod train step runs for the MoE family alone: on torch 2.13
(CPU) DTensor plans a 3-D mesh's strided redistributions of the other
families' backward by a graph search that takes 40-170 s a smoke cell
(the card's torch 2.11 runs every train cell of the grid in seconds).
"""

import math

import pytest

from dryrun_cells import FAMILIES, check_ok, clean_world, smoke  # noqa: F401
from repro_torch.configs.base import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.steps import abstract_params
from repro_torch.models.api import build

CELLS = [(f, s) for f in FAMILIES for s in ("prefill_32k", "decode_32k")]


@pytest.mark.parametrize("family,shape_name", CELLS,
                         ids=[f"{f}-{s}" for f, s in CELLS])
def test_each_family_runs_on_the_multi_pod_mesh(smoke, family, shape_name):
    rec = dryrun.run_cell(FAMILIES[family], shape_name, True, device="cpu")
    check_ok(rec, shape_name, True)
    assert rec["n_params"] == sum(
        math.prod(s.shape) for s in abstract_params(build(
            get_config(FAMILIES[family], smoke=True),
            device="meta")).values())


def test_multi_pod_train_cell(smoke):
    rec = dryrun.run_cell("phi3_5_moe", "train_4k", True, device="cpu")
    check_ok(rec, "train_4k", True)
    by_kind = rec["collectives"]["by_kind"]
    assert by_kind["all-reduce"] > 0 and by_kind["all-gather"] > 0
