"""Multi-pod dry-run (deliverable e).

For every (architecture x input-shape) cell, run the real train, prefill
or serve step once on the production mesh - 16x16 single-pod and 2x16x16
multi-pod - and record its per-device memory, cost, collective bytes and
roofline terms.  A cell that fails is a bug in the sharding config, not an
acceptable skip.

Torch has no lowering and no host of 512 devices.  The mesh is a world
of 256 or 512 ranks held in this one process by torch's fake process
group (``compat.fake_world``: collectives move nothing), the model,
optimizer state, batch and cache are meta DTensors (nothing is
allocated, no kernel is launched), and the step runs eagerly once under
``roofline.StepRecorder``, which counts what this rank (rank 0) executes.
``lower_s`` is that run's time; nothing compiles, so there is no
``compile_s`` and no generated code size.  The device only names the
mesh's device type: ``None`` is the CUDA device (raising without one),
the tests pass ``device="cpu"``.

Results are cached per cell in dryrun_results_torch/<cell>.json so the
sweep is resumable.  ``--jobs N`` runs the uncached cells in N worker
processes at once (each a fresh interpreter running one cell; the work is
host work, one core a cell), the longest first, then reports as usual.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun              # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama_1_1b \\
      --shape train_4k --multi-pod both --device cpu
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import functools
import json
import math
import operator
import os
import subprocess
import sys
import time
import traceback

import torch

from repro_torch.configs.base import (ARCH_IDS, SHAPES, get_config,
                                      shape_applicable)
from repro_torch.device import resolve_device
from repro_torch.distributed import compat, sharding
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (_tree_map_with_path, abstract_params,
                                      decode_input_specs, make_optimizer,
                                      make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models.api import (batch_shardings, batch_specs, build,
                                    shard_params)

RESULT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "dryrun_results_torch")
SRC_DIR = os.path.join(os.path.dirname(__file__), "..", "..")
# a worker process's limit for one cell (the 32k prefill of a 95-layer
# model takes about 20 minutes on one core)
CELL_TIMEOUT_S = 3 * 3600

OPT_FLAG_FIELDS = {
    # §Perf hillclimb knobs -> config overrides (see EXPERIMENTS.md §Perf)
    "bf16probs": {"attn_probs_dtype": "bfloat16"},
    "ce_recompute": {"ce_recompute": True},
    "moe_local": {"moe_local_dispatch": True},
    "noremat": {"remat": False},
    "losschunk512": {"loss_chunk": 512},
    "qchunk": {"attn_impl": "qchunk"},
    "flashattn": {"attn_impl": "flashref"},
    "tp_bf16": {"tp_bf16_reduce": True},
    "save_proj": {"save_proj_remat": True},
    "decode_inplace": {"decode_inplace": True},
}


def _apply_opt_flags(cfg, opt_flags):
    for f in opt_flags:
        if f in OPT_FLAG_FIELDS:
            cfg = dataclasses.replace(cfg, **OPT_FLAG_FIELDS[f])
        elif f != "nofsdp":
            raise ValueError(f"unknown opt flag {f!r}")
    return cfg


def _meta(spec, template):
    """A meta tensor of ``spec``'s shape and dtype placed by ``template``
    on the configured mesh."""
    t = torch.empty(tuple(spec.shape), dtype=spec.dtype, device="meta")
    return sharding.place(t, template)


def _placed_batch(cfg, shape) -> dict:
    tpl = batch_shardings(cfg, shape)
    return {k: _meta(s, tpl[k]) for k, s in batch_specs(cfg, shape).items()}


def _decode_inputs(api, shape):
    """(cache, token, index) of a decode cell: each cache leaf placed by
    its ``decode_input_specs`` template (the sequence split at batch 1),
    except the SSM state, placed as its constructor places it (ROADMAP
    D51); the index is the last position, a Python int as ``serve``
    passes it."""
    from repro_torch.models.mamba2 import SSM_STATE_TEMPLATE
    (cache_s, tok_s, _), (cache_t, tok_t, _) = decode_input_specs(api, shape)
    cache = _tree_map_with_path(
        lambda path, s: _meta(s, SSM_STATE_TEMPLATE if path[0] == "ssm"
                              else functools.reduce(operator.getitem, path,
                                                    cache_t)), cache_s)
    return cache, _meta(tok_s, tok_t), shape.seq_len - 1


def record_cell(cfg, shape, chips: int) -> dict:
    """The record of one cell's step on the configured mesh of ``chips``
    ranks (``sharding.set_mesh``; with none, on one device): everything
    ``run_cell`` records but the cell's name and status."""
    rec = {}
    api = build(cfg, device="meta")
    pshapes = abstract_params(api)
    rec["n_params"] = sum(math.prod(s.shape) for s in pshapes.values())
    if shape.kind == "decode":
        inputs = _decode_inputs(api, shape)   # before the params shard
    shard_params(api)
    params = dict(api.model.named_parameters())
    if shape.kind == "train":
        opt = make_optimizer(cfg)
        args = (params, opt.init(params), _placed_batch(cfg, shape))
        step, grad = make_train_step(api, opt), True
    elif shape.kind == "prefill":
        args = (_placed_batch(cfg, shape),)
        step, grad = make_prefill_step(api), False
    else:
        args = inputs
        step, grad = make_serve_step(api), False
    recorder = roofline.StepRecorder()
    t0 = time.time()
    with torch.set_grad_enabled(grad), recorder:
        out = step(*args)
    rec["lower_s"] = time.time() - t0
    held = args if shape.kind == "train" else (params,) + args
    rec["memory"] = {
        "argument_size_in_bytes": roofline.local_bytes(held),
        "output_size_in_bytes": roofline.local_bytes(out),
        "temp_size_in_bytes": recorder.peak,
        "alias_size_in_bytes": roofline.aliased_bytes(out, held),
    }
    rec["cost"] = roofline.cost_summary(recorder)
    coll = roofline.collective_bytes(recorder)
    rec["collectives"] = {"total_bytes": coll.total_bytes,
                          "count": coll.count, "by_kind": coll.by_kind}
    hc = roofline.hlo_cost(recorder)
    rec["hlo_cost"] = {k: v for k, v in hc.items() if k != "multiplicities"}
    rec["scan_multiplicities"] = hc["multiplicities"]
    flops = max(rec["cost"]["flops"], hc["dot_flops"])
    bytes_acc = max(rec["cost"]["bytes accessed"], hc["bytes"])
    rec["roofline"] = roofline.roofline_terms(flops, bytes_acc,
                                              coll.total_bytes, chips)
    mf = roofline.model_flops(cfg, shape)
    rec["model_flops"] = mf
    # flops is per-device (one rank's ops); model_flops is whole-job
    rec["useful_flops_ratio"] = (mf / chips / flops) if flops else None
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             opt_flags=(), *, device=None) -> dict:
    device = resolve_device(device)
    cfg = _apply_opt_flags(get_config(arch), opt_flags)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "opt_flags": list(opt_flags)}
    if not shape_applicable(cfg, shape):
        rec["status"] = "skipped"
        rec["reason"] = ("long_500k requires sub-quadratic attention; "
                         f"{cfg.name} is full-attention (DESIGN.md §4)")
        return rec

    t0 = time.time()
    try:
        with compat.fake_world(512 if multi_pod else 256):
            try:
                mesh = make_production_mesh(multi_pod=multi_pod,
                                            device_type=device.type)
                sharding.set_mesh(mesh, multi_pod=multi_pod,
                                  fsdp="nofsdp" not in opt_flags)
                rec.update(record_cell(cfg, shape, mesh.size()))
            finally:
                sharding.set_mesh(None)
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = time.time() - t0
    return rec


def cell_path(arch, shape_name, multi_pod, opt_flags=()):
    tag = "mp" if multi_pod else "sp"
    suffix = ("." + ".".join(sorted(opt_flags))) if opt_flags else ""
    return os.path.join(RESULT_DIR, f"{arch}.{shape_name}.{tag}{suffix}.json")


def _cell_order(cell):
    """Longest first: prefill (a 32k blockwise attention per layer), then
    train, then decode; deeper models first."""
    arch, shape_name, _ = cell
    kind = SHAPES[shape_name].kind
    return (("prefill", "train", "decode").index(kind),
            -get_config(arch).n_layers)


def _run_worker(cell, opt_flags, device) -> None:
    """One cell in a fresh interpreter (``main`` with ``--force``); a
    worker that dies or times out before writing the cell's file leaves a
    ``failed`` record."""
    arch, shape_name, mp = cell
    argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
            "--shape", shape_name, "--multi-pod", "multi" if mp else "single",
            "--force", "--device", device.type, "--opt", ",".join(opt_flags)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.abspath(SRC_DIR), os.environ.get("PYTHONPATH"))
        if p))
    path = cell_path(arch, shape_name, mp, opt_flags)
    try:
        proc = subprocess.run(argv, env=env, capture_output=True, text=True,
                              timeout=CELL_TIMEOUT_S)
        error = f"worker exit {proc.returncode}: {proc.stderr[-2000:]}"
    except subprocess.TimeoutExpired:
        error = f"worker timed out after {CELL_TIMEOUT_S} s"
    if not os.path.exists(path):
        with open(path, "w") as f:
            json.dump({"arch": arch, "shape": shape_name,
                       "mesh": "2x16x16" if mp else "16x16",
                       "opt_flags": list(opt_flags), "status": "failed",
                       "error": error}, f, indent=1)


def main(argv=None, *, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", default="both",
                    choices=["both", "single", "multi"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--opt", default="",
                    help="comma-separated optimization flags (perf loop)")
    ap.add_argument("--device", default=None,
                    help="the mesh's device type (default: the CUDA device)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="run the uncached cells in this many processes")
    args = ap.parse_args(argv)
    device = resolve_device(args.device or device)

    os.makedirs(RESULT_DIR, exist_ok=True)
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    pods = {"both": [False, True], "single": [False],
            "multi": [True]}[args.multi_pod]
    opt_flags = tuple(f for f in args.opt.split(",") if f)

    if args.jobs > 1:
        todo = sorted(
            ((a, s, mp) for a in archs for s in shapes for mp in pods
             if shape_applicable(get_config(a), SHAPES[s]) and (
                 args.force or not os.path.exists(
                     cell_path(a, s, mp, opt_flags)))), key=_cell_order)
        with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
            list(pool.map(lambda c: _run_worker(c, opt_flags, device), todo))
        args.force = False

    n_ok = n_fail = n_skip = 0
    for arch in archs:
        for shape_name in shapes:
            for mp in pods:
                path = cell_path(arch, shape_name, mp, opt_flags)
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        rec = json.load(f)
                else:
                    rec = run_cell(arch, shape_name, mp, opt_flags,
                                   device=device)
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                tag = rec["mesh"]
                if rec["status"] == "ok":
                    n_ok += 1
                    r = rec["roofline"]
                    print(f"OK   {arch:18s} {shape_name:12s} {tag:8s} "
                          f"lower={rec['lower_s']:.1f}s "
                          f"compute={r['compute_s']:.3e}s "
                          f"mem={r['memory_s']:.3e}s "
                          f"coll={r['collective_s']:.3e}s "
                          f"dom={r['dominant']}", flush=True)
                elif rec["status"] == "skipped":
                    n_skip += 1
                    print(f"SKIP {arch:18s} {shape_name:12s} {tag}",
                          flush=True)
                else:
                    n_fail += 1
                    print(f"FAIL {arch:18s} {shape_name:12s} {tag}: "
                          f"{rec['error'][:200]}", flush=True)
    print(f"\n{n_ok} ok / {n_skip} skipped / {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
