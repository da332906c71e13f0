"""Write the golden files the PyTorch port is held to on the GPU.

``tests/fixtures/torch/golden_tinyllama_systolic.json``:
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

``tests/fixtures/torch/golden_gpu_cachesim.json``: the reference's
cache-hierarchy ("gpu") backend with the default ``HierarchyConfig``
(128 KB / 8-way L1, 4 MB / 16-way L2, 128 B lines, write-allocate,
set-parallel replay) on the registry workload ``tinyllama_1_1b`` (seq 128,
``sample`` 8) at ``n_layers`` 2 and 22 and on every ``mlperf`` workload at
its registry parameters.  Per subpartition (L1, L2) it records event,
read, write and hit counts, a SHA-256 of the subpartition's trace in trace
order (time-sorted: int64 time_cycles, int64 addr, uint8 is_write, uint8
hit, little-endian, concatenated), the cache-mode lifetime count, orphans,
the 64-bin histogram of live lifetimes over ``default_edges()`` rounded up
to integers, exact ``sum_lt`` / ``max_lt``, the default composition's
capacity fractions and the short-lived access fraction at 1 us retention.
``--only gpu`` writes this file alone (about a minute; the 22-layer
entry holds a 10.6 M-event trace).

``tests/fixtures/torch/golden_zamba2_smoke.npz``: the reference's serving
loop (``serve.py``: prefill over prompt + generation tokens, then greedy
decode steps) on the Zamba2 smoke config with ``attn_impl="flash"`` (both
Pallas kernels, in interpret mode on the CPU) and ``param_dtype="float32"``,
parameters from ``PRNGKey(0)``, prompt tokens from a numpy seed.  It holds
the parameters (``param:<path>``), the tokens, the prefill logits and the
greedy tokens.  ``--only zamba2`` writes this file alone.

``tests/fixtures/torch/golden_tinyllama_train_smoke.npz``: three steps of
the reference's training step (``launch/steps.make_train_step`` with
``make_optimizer(cfg, total_steps=3)``) on the TinyLlama smoke config with
``attn_impl="flash"`` (the Pallas forward and backward kernels, in
interpret mode) and ``param_dtype="float32"``, parameters from
``PRNGKey(0)``, batches from ``SyntheticLMDataset`` (seed 0, batch 2 x
seq 64).  It holds the initial parameters (``param:<path>``), the batches,
the per-step ``loss``, ``grad_norm`` and ``lr``, and the parameters after
the last step (``final:<path>``).  ``--only train`` writes this file alone.

``tests/fixtures/torch/golden_<arch>_smoke.npz`` for ``deepseek_moe_16b``,
``internvl2_1b`` and ``whisper_small``: the reference's serving loop on the
smoke config (``param_dtype="float32"``; ``attn_impl="flash"``, the Pallas
kernels in interpret mode, where the port's kernels take the head dim, and
``"ref"`` for InternVL2's 14) over tokens, vision embeddings and mel frames
from a numpy seed, and one training step (``make_optimizer(cfg,
total_steps=1)``) on ``SyntheticLMDataset`` (seed 0, step 0).  It holds the
parameters (``param:<path>``; Whisper's ``dec_pos`` cut to its first
``DEC_POS_ROWS`` rows, the only ones a run reads), the serving batch
(``serve:<key>``), the prefill logits, the greedy tokens, the training
batch (``train:<key>``) and the step's ``loss``, ``grad_norm`` and ``lr``.
``--only families`` writes these files alone (seconds).

``tests/fixtures/torch/golden_tuned_<arch>.npz`` for all ten arch configs:
the reference's ``get_tuned_config(arch, smoke=True)`` (``flashref``
attention, ``save_proj_remat``, ``tp_bf16_reduce`` and, for MoE,
``moe_local_dispatch``, which takes the global path without a mesh) with
``param_dtype="float32"``: its serving loop over a prompt long enough that
the cached prefill takes ``qchunk_attention`` in two chunks of 512 rows and
the cache-less one ``flashref_attention``, and one training step at a
sequence whose scores pass the 256 x 256 limit, so ``flashref`` and its
backward run under ``save_proj_remat``.  Keys as in the families'
fixtures (Whisper's ``dec_pos`` cut to the ``TUNED_DEC_POS_ROWS`` rows a
run reads); where the config has ``tp_bf16_reduce``, which rounds the
projection outputs to bf16, the same run without it is stored beside, its
outputs under ``no_bf16_reduce:<key>``.  ``--only tuned`` writes these
files alone (about two minutes).

``tests/fixtures/torch/golden_campaign.json``: the reference's campaign
(``CampaignRunner``, thread scheduler, ``engine="numpy"``, the default
retention bins and sweep axes, no cache) over ``suite:mlperf,suite:polybench``
x ``systolic,gpu`` at registry parameters, reduced to its key-free facts by
``repro_torch.launch.campaign.campaign_facts``: per job the accesses and
short-lived fractions per subpartition, the capacity fractions and the sweep
points' area and energy against SRAM; and the cross-suite aggregate.
``--only campaign`` writes this file alone (about a minute).

``tests/fixtures/torch/golden_dryrun.json``: for every arch x shape cell of
the reference's dry-run grid, ``n_params`` (the elements of the
reference's abstract parameters, ``launch/steps.py`` ``abstract_params``),
``model_flops`` (``launch/roofline.py``) and whether the shape applies
(``shape_applicable``).  ``--only dryrun`` writes this file alone
(seconds).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
from pathlib import Path

import jax
import jax.experimental
import numpy as np

if not hasattr(jax.experimental, "enable_x64"):     # see tests/conftest.py
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.core import ProfileSession  # noqa: E402
from repro.kernels.lifetime_scan.ops import default_edges  # noqa: E402
from repro.kernels.lifetime_scan.ref import \
    lifetime_hist_reference  # noqa: E402
from repro.models import hybrid  # noqa: E402
from repro.workloads import get_workload  # noqa: E402

OUT = Path(__file__).parent / "fixtures" / "torch" / \
    "golden_tinyllama_systolic.json"
RUN = {"arch": "tinyllama_1_1b", "backend": "systolic", "seq": 128,
       "pe": 128, "dataflow": "ws"}
OUT_ZAMBA2 = Path(__file__).parent / "fixtures" / "torch" / \
    "golden_zamba2_smoke.npz"
ZAMBA2 = {"batch": 2, "prompt_len": 24, "gen": 8, "token_seed": 0}
OUT_TRAIN = Path(__file__).parent / "fixtures" / "torch" / \
    "golden_tinyllama_train_smoke.npz"
TRAIN = {"batch": 2, "seq": 64, "steps": 3, "data_seed": 0}
OUT_GPU = Path(__file__).parent / "fixtures" / "torch" / \
    "golden_gpu_cachesim.json"
OUT_CAMPAIGN = Path(__file__).parent / "fixtures" / "torch" / \
    "golden_campaign.json"
CAMPAIGN = {"workloads": "suite:mlperf,suite:polybench",
            "backends": ["systolic", "gpu"]}
# the families' smoke fixtures: attn_impl per arch (the port's kernels take
# head dims 16-128; InternVL2's smoke config has 14), serving and training
FAMILIES = {"deepseek_moe_16b": "flash", "internvl2_1b": "ref",
            "whisper_small": "flash"}
FAMILY_SERVE = {"batch": 2, "prompt_len": 24, "gen": 6, "token_seed": 0}
FAMILY_TRAIN = {"batch": 2, "seq": 32, "data_seed": 0}
DEC_POS_ROWS = 64
# the tuned configs' fixtures: prefill over prompt + gen = 524 positions
# (qchunk in chunks of 512, the last padded), a training step at seq 272
# (272 x 272 scores pass the 256 x 256 limit: flashref)
TUNED_SERVE = {"batch": 2, "prompt_len": 520, "gen": 4, "token_seed": 0}
TUNED_TRAIN = {"batch": 2, "seq": 272, "data_seed": 0}
TUNED_DEC_POS_ROWS = 528
TUNED_OUTPUTS = ("prefill_logits", "greedy_tokens", "loss", "grad_norm",
                 "lr")
# entry key -> (registry workload, param overrides)
OUT_DRYRUN = Path(__file__).parent / "fixtures" / "torch" / \
    "golden_dryrun.json"
GPU_ENTRIES = {"tinyllama_1_1b@2": ("tinyllama_1_1b", {"n_layers": 2}),
               "tinyllama_1_1b@22": ("tinyllama_1_1b", {"n_layers": 22})}


def flatten(tree, prefix=""):
    """Nested dicts of arrays -> {"a/b/c": float32 array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def golden_zamba2() -> dict:
    cfg = dataclasses.replace(get_config("zamba2_2_7b", smoke=True),
                              attn_impl="flash", param_dtype="float32")
    params, _ = hybrid.init_lm(jax.random.PRNGKey(0), cfg)
    total = ZAMBA2["prompt_len"] + ZAMBA2["gen"]
    tokens = np.random.default_rng(ZAMBA2["token_seed"]).integers(
        0, cfg.vocab, (ZAMBA2["batch"], total))
    logits, cache = hybrid.prefill(params, cfg, jnp.asarray(tokens,
                                                            jnp.int32))
    prefill_logits = np.asarray(logits, np.float32)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    outs = [np.asarray(tok)]
    for i in range(ZAMBA2["gen"] - 1):
        logits, cache = hybrid.decode_step(params, cfg, cache, tok,
                                           ZAMBA2["prompt_len"] + i)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        outs.append(np.asarray(tok))
    fixture = {f"param:{k}": v for k, v in flatten(params).items()}
    fixture.update(tokens=tokens.astype(np.int64),
                   prompt_len=np.int64(ZAMBA2["prompt_len"]),
                   gen=np.int64(ZAMBA2["gen"]),
                   prefill_logits=prefill_logits,
                   greedy_tokens=np.stack(outs, 1).astype(np.int64))
    return fixture


def golden_train() -> dict:
    from repro.configs.base import ShapeCell
    from repro.data import SyntheticLMDataset
    from repro.launch.steps import make_optimizer, make_train_step
    from repro.models.api import build
    cfg = dataclasses.replace(get_config("tinyllama_1_1b", smoke=True),
                              attn_impl="flash", param_dtype="float32")
    api = build(cfg)
    params, _ = api.init(jax.random.PRNGKey(0))
    opt = make_optimizer(cfg, total_steps=TRAIN["steps"])
    step = jax.jit(make_train_step(api, opt))
    ds = SyntheticLMDataset(
        cfg, ShapeCell("train", "train", TRAIN["seq"], TRAIN["batch"]),
        seed=TRAIN["data_seed"])
    fixture = {f"param:{k}": v for k, v in flatten(params).items()}
    state = opt.init(params)
    batches, metrics = [], []
    for i in range(TRAIN["steps"]):
        batch = ds.get_batch(i)
        batches.append(batch)
        params, state, m = step(params, state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    fixture.update({f"final:{k}": v for k, v in flatten(params).items()})
    fixture.update(
        tokens=np.stack([b["tokens"] for b in batches]).astype(np.int64),
        labels=np.stack([b["labels"] for b in batches]).astype(np.int64),
        **{k: np.array([m[k] for m in metrics], np.float32)
           for k in ("loss", "grad_norm", "lr")})
    return fixture


def family_path(arch: str) -> Path:
    return Path(__file__).parent / "fixtures" / "torch" / \
        f"golden_{arch}_smoke.npz"


def tuned_path(arch: str) -> Path:
    return Path(__file__).parent / "fixtures" / "torch" / \
        f"golden_tuned_{arch}.npz"


def golden_family(arch: str, cfg=None, serve_shape=FAMILY_SERVE,
                  train_shape=FAMILY_TRAIN,
                  dec_pos_rows=DEC_POS_ROWS) -> dict:
    """The family fixture of ``arch``'s smoke config (``cfg``: a variant of
    it, as the tuned fixtures pass)."""
    from repro.configs.base import ShapeCell
    from repro.data import SyntheticLMDataset
    from repro.launch.steps import make_optimizer, make_train_step
    from repro.models.api import build
    if cfg is None:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  attn_impl=FAMILIES[arch],
                                  param_dtype="float32")
    api = build(cfg)
    params, _ = api.init(jax.random.PRNGKey(0))
    B, P, G = (serve_shape[k] for k in ("batch", "prompt_len", "gen"))
    rng = np.random.default_rng(serve_shape["token_seed"])
    serve = {"tokens": rng.integers(0, cfg.vocab, (B, P + G))}
    if cfg.family == "vlm":
        serve["vision"] = rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model), dtype=np.float32)
    if cfg.family == "audio":
        serve["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model), dtype=np.float32)
    jbatch = {k: jnp.asarray(v, jnp.int32) if k == "tokens"
              else jnp.asarray(v) for k, v in serve.items()}
    logits, cache = jax.jit(api.prefill)(params, jbatch)
    prefill_logits = np.asarray(logits, np.float32)
    decode = jax.jit(api.decode)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    outs = [np.asarray(tok)]
    for i in range(G - 1):
        logits, cache = decode(params, cache, tok, jnp.int32(P + i))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        outs.append(np.asarray(tok))

    ds = SyntheticLMDataset(
        cfg, ShapeCell("train", "train", train_shape["seq"],
                       train_shape["batch"]), seed=train_shape["data_seed"])
    train = ds.get_batch(0)
    opt = make_optimizer(cfg, total_steps=1)
    _, _, m = jax.jit(make_train_step(api, opt))(params, opt.init(params),
                                                 train)
    flat = flatten(params)
    if "dec_pos" in flat:
        flat["dec_pos"] = flat["dec_pos"][:dec_pos_rows]
    fixture = {f"param:{k}": v for k, v in flat.items()}
    fixture.update({f"serve:{k}": v.astype(np.int64) if k == "tokens"
                    else v for k, v in serve.items()})
    fixture.update({f"train:{k}": v.astype(np.int64) if v.dtype.kind == "i"
                    else v for k, v in train.items()})
    fixture.update(prompt_len=np.int64(P), gen=np.int64(G),
                   attn_impl=np.str_(cfg.attn_impl),
                   prefill_logits=prefill_logits,
                   greedy_tokens=np.stack(outs, 1).astype(np.int64),
                   **{k: np.float32(m[k]) for k in ("loss", "grad_norm",
                                                    "lr")})
    return fixture


def golden_tuned(arch: str) -> dict:
    from repro.configs.base import get_tuned_config
    cfg = dataclasses.replace(get_tuned_config(arch, smoke=True),
                              param_dtype="float32")
    fixture = golden_family(arch, cfg, TUNED_SERVE, TUNED_TRAIN,
                            TUNED_DEC_POS_ROWS)
    if cfg.tp_bf16_reduce:
        exact = golden_family(arch, dataclasses.replace(
            cfg, tp_bf16_reduce=False), TUNED_SERVE, TUNED_TRAIN,
            TUNED_DEC_POS_ROWS)
        fixture.update({f"no_bf16_reduce:{k}": exact[k]
                        for k in TUNED_OUTPUTS})
    return fixture


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


def integer_edges() -> np.ndarray:
    """``default_edges()`` rounded up to int64 (+inf -> int64 max): for
    integer lifetimes ``lt >= e`` iff ``lt >= ceil(e)``."""
    e = np.ceil(np.asarray(default_edges(), np.float64))
    out = np.full(len(e), np.iinfo(np.int64).max, np.int64)
    out[np.isfinite(e)] = e[np.isfinite(e)].astype(np.int64)
    return out


def trace_digest(t_sub) -> str:
    """SHA-256 of one subpartition's trace, in trace order."""
    h = hashlib.sha256()
    for arr, dt in ((t_sub.time_cycles, "<i8"), (t_sub.addr, "<i8"),
                    (t_sub.is_write, "u1"), (t_sub.hit, "u1")):
        h.update(np.ascontiguousarray(np.asarray(arr).astype(dt)).tobytes())
    return h.hexdigest()


def gpu_entry(workload: str, params: dict) -> dict:
    spec = get_workload(workload)
    if params:
        spec = spec.with_params(**params)
    program, cfg = spec.build("gpu")
    session = ProfileSession("gpu")
    session.profile(program, **cfg)
    report = session.analyze().compose().report()
    trace = session.trace
    ie = integer_edges()
    entry = {"workload": workload, "params": params,
             "backend_cfg": cfg, "n_events": trace.n_events,
             "subpartitions": {}}
    for sub, name in enumerate(trace.names):
        t_sub = trace.select(sub)
        rep = report["subpartitions"][name]
        _, raw = session.subpartition_stats(name)
        valid = np.asarray(raw.valid)
        orphan = np.asarray(raw.orphan)
        lt = np.asarray(raw.lifetime_cycles)[valid & ~orphan]
        bins = np.searchsorted(ie, lt, side="right") - 1
        n_reads, n_writes = t_sub.counts()
        entry["subpartitions"][name] = {
            "n_events": t_sub.n_events,
            "n_reads": n_reads,
            "n_writes": n_writes,
            "n_hits": int(np.asarray(t_sub.hit).sum()),
            "trace_sha256": trace_digest(t_sub),
            "n_lifetimes": rep["n_lifetimes"],
            "unique_addrs": rep["unique_addrs"],
            "orphans": int((valid & orphan).sum()),
            "live": int(len(lt)),
            "hist": np.bincount(bins, minlength=len(ie) - 1).tolist(),
            "sum_lt": int(lt.sum()),
            "max_lt": int(lt.max()) if len(lt) else 0,
            "composition_devices": rep["composition"]["devices"],
            "capacity_fractions":
                rep["composition"]["capacity_fractions"],
            "short_lived_fraction_1us":
                session.short_lived_fraction(name, 1e-6),
        }
    return entry


def golden_gpu() -> dict:
    from repro.workloads import available_workloads
    entries = dict(GPU_ENTRIES)
    entries.update((w, (w, {})) for w in available_workloads("mlperf"))
    golden = {"run": {"backend": "gpu", "hierarchy": "HierarchyConfig()"},
              "entries": {}}
    for key, (workload, params) in entries.items():
        golden["entries"][key] = gpu_entry(workload, params)
        print(f"gpu {key}: {golden['entries'][key]['n_events']} events")
    return golden


def golden_campaign() -> dict:
    from repro.launch.campaign import (DEFAULT_RETENTION_BINS,
                                       DEFAULT_SWEEP_AXES, CampaignRunner)
    from repro_torch.launch.campaign import campaign_facts
    result = CampaignRunner(CAMPAIGN["workloads"], CAMPAIGN["backends"],
                            jobs=1).run()
    if result.failed:
        raise RuntimeError(f"reference campaign: {result.errors}")
    run = {**CAMPAIGN, "engine": "numpy",
           "retention_bins": list(DEFAULT_RETENTION_BINS),
           "sweep_axes": DEFAULT_SWEEP_AXES,
           "jobs": [j.label for j in result.jobs]}
    return {"run": run, **campaign_facts(result.artifacts, result.aggregate)}


def golden_dryrun() -> dict:
    import math
    from repro.configs.base import ARCH_IDS, SHAPES, shape_applicable
    from repro.launch.roofline import model_flops
    from repro.launch.steps import abstract_params
    from repro.models.api import build
    cells = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        pshapes, _ = abstract_params(build(cfg))
        n_params = sum(math.prod(x.shape) for x in jax.tree.leaves(pshapes))
        cells[arch] = {name: {"n_params": n_params,
                              "model_flops": model_flops(cfg, shape),
                              "applicable": shape_applicable(cfg, shape)}
                       for name, shape in SHAPES.items()}
    return {"cells": cells}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 22])
    ap.add_argument("--only",
                    choices=["tinyllama", "zamba2", "train", "gpu",
                             "campaign", "families", "tuned", "dryrun"])
    args = ap.parse_args(argv)
    if args.only in (None, "dryrun"):
        OUT_DRYRUN.write_text(json.dumps(golden_dryrun(), indent=1) + "\n")
        print(f"wrote {OUT_DRYRUN}")
    if args.only in (None, "campaign"):
        OUT_CAMPAIGN.write_text(json.dumps(golden_campaign(), indent=1)
                                + "\n")
        print(f"wrote {OUT_CAMPAIGN}")
    if args.only in (None, "gpu"):
        OUT_GPU.parent.mkdir(parents=True, exist_ok=True)
        OUT_GPU.write_text(json.dumps(golden_gpu(), indent=1) + "\n")
        print(f"wrote {OUT_GPU}")
    if args.only in (None, "zamba2"):
        np.savez_compressed(OUT_ZAMBA2, **golden_zamba2())
        print(f"wrote {OUT_ZAMBA2}")
    if args.only in (None, "train"):
        np.savez_compressed(OUT_TRAIN, **golden_train())
        print(f"wrote {OUT_TRAIN}")
    if args.only in (None, "families"):
        for arch in FAMILIES:
            np.savez_compressed(family_path(arch), **golden_family(arch))
            print(f"wrote {family_path(arch)}")
    if args.only in (None, "tuned"):
        from repro.configs.base import ARCH_IDS
        for arch in ARCH_IDS:
            np.savez_compressed(tuned_path(arch), **golden_tuned(arch))
            print(f"wrote {tuned_path(arch)}")
    if args.only in ("zamba2", "train", "gpu", "campaign", "families",
                     "tuned", "dryrun"):
        return
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
