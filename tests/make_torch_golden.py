"""Write ``tests/fixtures/torch/golden_tinyllama_systolic.json``.

Runs the JAX *reference* package on the registry workload
``tinyllama_1_1b`` (systolic backend, seq 128, 128 x 128 PEs, ``ws``
dataflow, full TinyLlama widths) at ``n_layers`` 2 and 22 and records, per
subpartition, the integer facts the PyTorch port must reproduce on the GPU:
event and lifetime counts, the 64-bin ``default_edges()`` histogram of
``lifetime_hist_reference``, exact int64 ``sum_lt`` / ``max_lt``, and the
default composition's capacity fractions.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_torch_golden.py

The 22-layer run holds a 33.6 M-event trace; pass ``--layers 2`` to write
the small entry only (an entry that is not rerun is kept from the file).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import jax
import jax.experimental
import numpy as np

if not hasattr(jax.experimental, "enable_x64"):     # see tests/conftest.py
    jax.experimental.enable_x64 = jax.enable_x64

from repro.core import ProfileSession  # noqa: E402
from repro.kernels.lifetime_scan.ops import default_edges  # noqa: E402
from repro.kernels.lifetime_scan.ref import \
    lifetime_hist_reference  # noqa: E402
from repro.workloads import get_workload  # noqa: E402

OUT = Path(__file__).parent / "fixtures" / "torch" / \
    "golden_tinyllama_systolic.json"
RUN = {"arch": "tinyllama_1_1b", "backend": "systolic", "seq": 128,
       "pe": 128, "dataflow": "ws"}


def golden_entry(n_layers: int) -> dict:
    spec = get_workload(RUN["arch"]).with_params(seq=RUN["seq"],
                                                 n_layers=n_layers)
    workload, cfg = spec.build(RUN["backend"])
    session = ProfileSession(RUN["backend"])
    session.profile(workload, rows=RUN["pe"], cols=RUN["pe"],
                    dataflow=RUN["dataflow"], **cfg)
    report = session.analyze().compose().report()
    trace = session.trace
    entry = {"n_layers": n_layers, "n_events": trace.n_events,
             "subpartitions": {}}
    for sub, name in enumerate(trace.names):
        rep = report["subpartitions"][name]
        _, raw = session.subpartition_stats(name)
        valid = np.asarray(raw.valid)
        orphan = np.asarray(raw.orphan)
        lt = np.asarray(raw.lifetime_cycles)[valid & ~orphan]
        t_sub = trace.select(sub)
        hist, stats = lifetime_hist_reference(
            t_sub.time_cycles, t_sub.addr, t_sub.is_write, default_edges())
        # the oracle's counts are f32: exact below 2**24, as all are here
        assert hist.sum() == len(lt) and stats[1] == orphan.sum()
        assert len(lt) < 2 ** 24
        entry["subpartitions"][name] = {
            "n_reads": rep["n_reads"],
            "n_writes": rep["n_writes"],
            "n_lifetimes": rep["n_lifetimes"],
            "unique_addrs": rep["unique_addrs"],
            "orphans": int(orphan.sum()),
            "live": int(len(lt)),
            "hist": [int(v) for v in hist],
            "sum_lt": int(lt.sum()),
            "max_lt": int(lt.max()) if len(lt) else 0,
            "composition_devices": rep["composition"]["devices"],
            "capacity_fractions":
                rep["composition"]["capacity_fractions"],
        }
    return entry


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 22])
    args = ap.parse_args(argv)
    golden = json.loads(OUT.read_text()) if OUT.exists() else {}
    golden["run"] = RUN
    golden.setdefault("entries", {})
    for n_layers in args.layers:
        golden["entries"][str(n_layers)] = golden_entry(n_layers)
        print(f"n_layers={n_layers}: "
              f"{golden['entries'][str(n_layers)]['n_events']} events")
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(golden, indent=1) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
