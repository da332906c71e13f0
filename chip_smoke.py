#!/usr/bin/env python3
"""On-GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and no network; exits non-zero without a
GPU.  It builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
per source, all at once), holds each kernel against its plain PyTorch
version on the card, and drives the port's two paths:

* profiling: the profile CLI, then profile -> analyze -> compose at the full
  width and depth of TinyLlama-1.1B and the ``lifetime_scan`` entry point on
  the traces the session profiled, checked against the session's own
  lifetimes and the golden file written from the JAX reference;
* serving: ``launch.serve.generate`` on the Zamba2 smoke config against the
  JAX reference's golden logits and tokens, then Zamba2-2.7B at full width
  and depth (54 Mamba-2 blocks, 9 shared-attention applications) with the
  flash-attention and SSD-scan kernels, checked against the same model
  through the kernels' plain versions;
* training: ``launch.steps.make_train_step`` on the TinyLlama smoke config
  against the JAX reference's three golden steps, then again under
  ``TrainSupervisor`` and ``CheckpointManager`` with a fault injected (the
  replayed losses must be bit-equal), then TinyLlama-1.1B at full width and
  depth (22 layers, bf16 parameters, fp32 AdamW state, per-layer remat,
  batch 4 x 2048) for five steps with the flash-attention forward and
  backward kernels, checked against the same model through the kernels'
  plain versions in float32.

Then it times each kernel at the shapes its path gives it.

Output: the ``nvidia-smi`` name/power-limit line, then one JSON object per
phase (``device``, ``build``, ``kernel_check`` per kernel, ``cli``,
``full``, ``golden``, ``serve``, ``train_golden``, ``train``), then the
``kernels`` line, then ``{"ok": true, "device": {...}}`` as the last line.
Any failed phase raises: nothing is caught, nothing falls back to the CPU or
to a plain version.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

GOLDEN = ROOT / "tests" / "fixtures" / "torch" / \
    "golden_tinyllama_systolic.json"
FULL_LAYERS = 22                 # TinyLlama-1.1B's own depth
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published peak
# float32 outside the tensor cores peaks at 67 TFLOP/s counting a fused
# multiply-add as two; taken as 33.5e12 instructions/s for integer work
INT_OPS_PER_S = 33.5e12
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
KERNEL_SOURCE = "src/repro_torch/csrc/lifetime_scan.cu"
KERNEL_REPLACES = "src/repro/kernels/lifetime_scan/kernel.py:49"
SOURCES = ("lifetime_scan", "flash_attention_fwd", "ssd_scan",
           "flash_attention_bwd")
FA_SOURCE = "src/repro_torch/csrc/flash_attention_fwd.cu"
FA_REPLACES = "src/repro/kernels/flash_attention/kernel.py:26"
SSD_SOURCE = "src/repro_torch/csrc/ssd_scan.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan/kernel.py:23"
GOLDEN_ZAMBA2 = ROOT / "tests" / "fixtures" / "torch" / \
    "golden_zamba2_smoke.npz"
# the CPU tests' tolerances (atol = rtol), per dtype
FA_TOL = {"float32": 2e-6, "bfloat16": 2e-2}
SSD_TOL = {"float32": 5e-4, "bfloat16": 5e-2}
GOLDEN_LOGIT_TOL = 1e-4          # float32 smoke logits against JAX on CPU
# Zamba2-2.7B as published (bf16), served with the kernels
SERVE = {"arch": "zamba2_2_7b", "batch": 4, "prompt_len": 1008, "gen": 16,
         "param_seed": 0, "token_seed": 1}
# kernel path against plain path: max |diff| over max |logit| of the
# prefill logits.  In bf16 the paths round at other places and 63 residual
# stages amplify it, so the serve line also gives the distance of a second
# plain implementation (the reference's non-kernel path, attn_impl="ref")
# to the plain path as the yardstick.  In float32, with the same weights,
# rounding no longer hides a fault and the bound is tight.
SERVE_REL_TOL = {"bfloat16": 0.5, "float32": 1e-3}
BWD_SOURCE = "src/repro_torch/csrc/flash_attention_bwd.cu"
DQ_REPLACES = "src/repro/kernels/flash_attention/kernel_bwd.py:38"
DKV_REPLACES = "src/repro/kernels/flash_attention/kernel_bwd.py:79"
# backward kernels against their plain version (atol = rtol), per dtype
BWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GOLDEN_TRAIN = ROOT / "tests" / "fixtures" / "torch" / \
    "golden_tinyllama_train_smoke.npz"
# the smoke training steps on the card against the JAX reference's (CPU):
# loss and grad_norm relative, lr relative, final parameters abs + rel (as
# tests/test_torch_train.py holds the CPU path)
TRAIN_GOLDEN_TOL = {"loss": 1e-5, "grad_norm": 1e-5, "lr": 1e-6,
                    "params": 1e-5}
# TinyLlama-1.1B as published (bf16 parameters, remat), trained with the
# kernels: batch x seq tokens per step (seq = TinyLlama's context)
TRAIN = {"arch": "tinyllama_1_1b", "batch": 4, "seq": 2048, "steps": 5,
         "param_seed": 0, "data_seed": 0}
# kernel path against plain path, float32 weights, one step: relative loss
# difference and each gradient leaf's relative 2-norm difference
TRAIN_REL_TOL = {"loss": 1e-4, "grad": 1e-3}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, runs: int) -> list:
    """Per-run milliseconds of ``fn`` by CUDA events, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop))
    return out


def random_sorted_trace(n, n_addrs, p_write, seed, torch, device):
    """A seeded random event stream on the card, sorted by (addr, time):
    times past 2**40, addresses at and above 2**31."""
    from repro_torch.core.lifetime import sort_by_addr_time
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    t = torch.randint(0, 10 * n + 1, (n,), generator=g, device=device,
                      dtype=torch.int64) + 2 ** 40
    a = torch.randint(0, n_addrs, (n,), generator=g, device=device,
                      dtype=torch.int64) * 3 + 2 ** 31
    w = torch.rand(n, generator=g, device=device) < p_write
    order = sort_by_addr_time(t, a)
    return t[order], a[order], w[order]


def phase_kernel_check(torch, device) -> dict:
    from repro_torch.kernels.lifetime_scan import kernel as k
    from repro_torch.kernels.lifetime_scan.ops import (default_edges,
                                                       integer_edges)
    edges = torch.from_numpy(integer_edges(default_edges())).to(device)
    cases, max_err = 0, 0
    for n in (1, 257, 100_000, 10_000_000):
        for n_addrs in (3, max(4, n // 8)):
            for p_write in (0.05, 0.35, 0.95):
                t, a, w = random_sorted_trace(
                    n, n_addrs, p_write, seed=cases, torch=torch,
                    device=device)
                hist, stats = k.lifetime_scan_sorted(t, a, w, edges)
                torch.cuda.synchronize()
                hist_p, stats_p = k.lifetime_scan_plain(t, a, w, edges)
                err = max(int((hist - hist_p).abs().max()),
                          int((stats - stats_p).abs().max()))
                max_err = max(max_err, err)
                if err != 0:
                    raise AssertionError(
                        f"lifetime_scan kernel != plain version at n={n} "
                        f"n_addrs={n_addrs} p_write={p_write}: "
                        f"{stats.tolist()} vs {stats_p.tolist()}")
                if int(stats[0] + stats[1]) < 1 or \
                        int(stats[4] + stats[5]) != n:
                    raise AssertionError("kernel_check trace is degenerate")
                cases += 1
    emit("kernel_check", kernel="lifetime_scan", cases=cases,
         tolerance="exact (int64)", max_abs_err=max_err)
    return {"max_abs_err": max_err}


@contextlib.contextmanager
def routed(flash_attention_bhsd, ssd_scan_chunked, flash_attention_bwd_bhsd):
    """Route the flash-attention forward and backward and the SSD entry
    points (``ops``) to the given functions for the duration."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    saved = (fa_ops.flash_attention_bhsd, ssd_ops.ssd_scan_chunked,
             fa_ops.flash_attention_bwd_bhsd)
    fa_ops.flash_attention_bhsd = flash_attention_bhsd
    ssd_ops.ssd_scan_chunked = ssd_scan_chunked
    fa_ops.flash_attention_bwd_bhsd = flash_attention_bwd_bhsd
    try:
        yield
    finally:
        (fa_ops.flash_attention_bhsd, ssd_ops.ssd_scan_chunked,
         fa_ops.flash_attention_bwd_bhsd) = saved


def plain_kernels():
    """The kernels' plain versions in place of the kernels (the reference
    side of a comparison on the card; they launch and count nothing)."""
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention import kernel_bwd as bwd_k
    from repro_torch.kernels.ssd_scan import kernel as ssd_k
    return routed(fa_k.flash_attention_plain, ssd_k.ssd_scan_plain,
                  bwd_k.flash_attention_bwd_plain)


@contextlib.contextmanager
def first_calls():
    """The kernels as they are, recording the inputs and outputs of each
    one's first call on the path: yields {name: (args, kwargs, out)}."""
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.ssd_scan import kernel as ssd_k
    seen = {}

    def recorder(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen.setdefault(name, (args, kwargs, out))
            return out
        return call
    from repro_torch.kernels.flash_attention import kernel_bwd as bwd_k
    with routed(recorder("flash_attention_fwd", fa_k.flash_attention_bhsd),
                recorder("ssd_scan", ssd_k.ssd_scan_chunked),
                recorder("flash_attention_bwd",
                         bwd_k.flash_attention_bwd_bhsd)):
        yield seen


def within(got, want, tol, what) -> float:
    """max |got - want|; raises where |got - want| > tol + tol |want|."""
    got, want = got.detach().float(), want.detach().float()
    diff = (got - want).abs()
    if not bool(got.isfinite().all()) or \
            bool((diff > tol + tol * want.abs()).any()):
        raise AssertionError(
            f"{what}: kernel != plain version (max |diff| "
            f"{float(diff.max())}, tolerance {tol} abs + rel)")
    return float(diff.max())


def phase_fa_check(torch, device) -> dict:
    """K2 against its plain version: every head dim the kernel is built for
    (80 is Zamba2-2.7B's), GQA, Sq != Skv, causal and not, ragged lengths,
    the model layout's strided views, both dtypes, and the serving shape."""
    from repro_torch.kernels.flash_attention import kernel as k
    shapes = [  # (B, H, KV, Sq, Skv, hd, causal, model layout)
        (1, 2, 2, 128, 128, 16, True, False),
        (2, 4, 2, 256, 200, 64, False, True),
        (1, 8, 2, 256, 100, 80, True, False),
        (2, 4, 1, 77, 130, 128, False, False),
        (1, 4, 4, 100, 300, 80, True, True),
        (2, 6, 3, 193, 193, 64, True, True),
        (1, 2, 1, 1, 50, 128, False, False),
        (1, 2, 2, 33, 33, 32, True, True),
        (1, 4, 2, 70, 90, 48, True, True),
        (1, 3, 1, 65, 65, 96, False, False),
        (2, 2, 2, 64, 129, 112, True, False),
    ]
    cases, max_err = [], {"float32": 0.0, "bfloat16": 0.0}
    runs = [(s, dt) for s in shapes for dt in ("float32", "bfloat16")]
    runs.append(((4, 32, 32, 1024, 1024, 80, True, True), "bfloat16"))
    for i, ((B, H, KV, Sq, Skv, hd, causal, model), dt) in enumerate(runs):
        g = torch.Generator(device=device).manual_seed(100 + i)
        dtype = getattr(torch, dt)

        def make(heads, s):
            if model:       # [B, S, heads, hd] as the attention block has it
                x = torch.randn((B, s, heads, hd), generator=g,
                                device=device).to(dtype)
                return x.transpose(1, 2)
            return torch.randn((B, heads, s, hd), generator=g,
                               device=device).to(dtype)
        q, kk, v = make(H, Sq), make(KV, Skv), make(KV, Skv)
        o, lse = k.flash_attention_bhsd(q, kk, v, causal=causal)
        torch.cuda.synchronize()
        o_p, lse_p = k.flash_attention_plain(q, kk, v, causal=causal)
        tol = FA_TOL[dt]
        what = f"flash_attention {dt} {(B, H, KV, Sq, Skv, hd, causal)}"
        err = max(within(o, o_p, tol, what + " o"),
                  within(lse, lse_p, tol, what + " lse"))
        max_err[dt] = max(max_err[dt], err)
        cases.append([B, H, KV, Sq, Skv, hd, causal, model, dt, err])
    emit("kernel_check", kernel="flash_attention_fwd", cases=len(cases),
         tolerance={d: f"{t} abs + {t} rel, o and lse"
                    for d, t in FA_TOL.items()},
         max_abs_err=max_err, detail=cases)
    return {"max_abs_err": max(max_err.values())}


def ssd_inputs(torch, device, b, l, h, p, n, dt_x, dt_bc, seed):
    g = torch.Generator(device=device).manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=device)
    x = rn(b, l, h, p).to(getattr(torch, dt_x))
    dt = torch.nn.functional.softplus(rn(b, l, h))
    A = -torch.exp(rn(h) * 0.5)
    B = rn(b, l, n).to(getattr(torch, dt_bc))
    C = rn(b, l, n).to(getattr(torch, dt_bc))
    return x, dt, A, B, C, torch.ones(h, device=device)


def phase_ssd_check(torch, device) -> dict:
    """K5 against its plain version (both through ``ops.ssd_scan``'s
    padding): chunk 32/64/256, ragged l, fp32 and bf16 (and bf16 x with
    fp32 B/C), Zamba2-2.7B's (h, p, n) and the smoke config's, and the
    serving shape."""
    from repro_torch.kernels.ssd_scan import ops
    runs = [  # (b, l, h, p, n, chunk, x dtype, B/C dtype)
        (2, 256, 80, 64, 64, 32, "float32", "float32"),
        (1, 300, 80, 64, 64, 64, "float32", "float32"),
        (2, 512, 80, 64, 64, 256, "float32", "float32"),
        (1, 100, 80, 64, 64, 256, "float32", "float32"),
        (2, 256, 80, 64, 64, 32, "bfloat16", "bfloat16"),
        (1, 300, 80, 64, 64, 64, "bfloat16", "bfloat16"),
        (2, 512, 80, 64, 64, 256, "bfloat16", "float32"),
        (1, 100, 80, 64, 64, 256, "bfloat16", "bfloat16"),
        (2, 40, 8, 16, 16, 32, "float32", "float32"),
        (1, 37, 3, 8, 8, 16, "float32", "float32"),
        (4, 1024, 80, 64, 64, 256, "bfloat16", "bfloat16"),
    ]
    cases, max_err = [], {"float32": 0.0, "bfloat16": 0.0}
    for i, (b, l, h, p, n, chunk, dx, dbc) in enumerate(runs):
        x, dt, A, B, C, D = ssd_inputs(torch, device, b, l, h, p, n, dx, dbc,
                                       seed=200 + i)
        y = ops.ssd_scan(x, dt, A, B, C, D, chunk=chunk)
        torch.cuda.synchronize()
        with plain_kernels():
            y_p = ops.ssd_scan(x, dt, A, B, C, D, chunk=chunk)
        err = within(y, y_p, SSD_TOL[dx],
                     f"ssd_scan {(b, l, h, p, n, chunk, dx, dbc)}")
        max_err[dx] = max(max_err[dx], err)
        cases.append([b, l, h, p, n, chunk, dx, dbc, err])
    emit("kernel_check", kernel="ssd_scan", cases=len(cases),
         tolerance={d: f"{t} abs + {t} rel" for d, t in SSD_TOL.items()},
         max_abs_err=max_err, detail=cases)
    return {"max_abs_err": max(max_err.values())}


def reset_serving_counts():
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.ssd_scan import kernel as ssd_k
    fa_k.flash_attention_bhsd.launches = 0
    ssd_k.ssd_scan_chunked.launches = 0


def serving_counts() -> tuple:
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.ssd_scan import kernel as ssd_k
    return (fa_k.flash_attention_bhsd.launches,
            ssd_k.ssd_scan_chunked.launches)


def expected_counts(cfg) -> tuple:
    return cfg.n_layers // cfg.attn_every, cfg.n_layers


def phase_golden(torch, np, device) -> None:
    """``generate`` on the card, with the kernels, at the Zamba2 smoke
    width, against the JAX reference's logits and greedy tokens."""
    from repro_torch.configs.base import get_config
    from repro_torch.convert import load_reference_params, tree_from_flat
    from repro_torch.launch.serve import generate
    from repro_torch.models.api import build

    fx = dict(np.load(GOLDEN_ZAMBA2))
    cfg = dataclasses.replace(get_config("zamba2_2_7b", smoke=True),
                              attn_impl="flash", param_dtype="float32")
    api = build(cfg, device=device)
    load_reference_params(api.model, tree_from_flat(fx))
    tokens = torch.from_numpy(fx["tokens"]).to(device)
    reset_serving_counts()
    out = generate(api, tokens, int(fx["prompt_len"]), int(fx["gen"]))
    counts = serving_counts()
    logits = out.prefill_logits.cpu().numpy()
    err = float(np.abs(logits - fx["prefill_logits"]).max())
    if not np.isfinite(logits).all() or err > GOLDEN_LOGIT_TOL:
        raise AssertionError(f"golden: prefill logits differ from the JAX "
                             f"reference by {err} > {GOLDEN_LOGIT_TOL}")
    got = out.tokens.cpu().numpy()
    if not np.array_equal(got, fx["greedy_tokens"]):
        raise AssertionError(f"golden: greedy tokens {got.tolist()} != "
                             f"{fx['greedy_tokens'].tolist()}")
    if counts != expected_counts(cfg):
        raise AssertionError(f"golden: (flash_attention, ssd_scan) launches "
                             f"{counts}, expected {expected_counts(cfg)}")
    emit("golden", config="zamba2 smoke, attn_impl=flash, float32",
         batch=int(tokens.shape[0]), tokens=int(tokens.shape[1]),
         gen=int(fx["gen"]), max_abs_logit_err=err,
         tolerance=GOLDEN_LOGIT_TOL, tokens_equal=True,
         launches={"flash_attention_fwd": counts[0], "ssd_scan": counts[1]})


def phase_serve(torch, device) -> dict:
    """Zamba2-2.7B at full width and depth, random weights from a seed, the
    kernels on: prefill over prompt + generation tokens, greedy decode.

    Checks: each kernel's first call on the path against its plain version
    on the same inputs (the kernel_check tolerances); the prefill logits
    against the same model through the plain versions, in the published
    bf16 and again with the same weights in float32."""
    from repro_torch.configs.base import ShapeCell, get_config
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.ssd_scan import kernel as ssd_k
    from repro_torch.launch.serve import generate
    from repro_torch.models.api import build

    cfg = dataclasses.replace(get_config(SERVE["arch"]), attn_impl="flash")
    t0 = time.perf_counter()
    api = build(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(SERVE["param_seed"]))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in api.model.parameters())
    total = SERVE["prompt_len"] + SERVE["gen"]
    tokens = api.make_batch(
        torch.Generator(device=device).manual_seed(SERVE["token_seed"]),
        ShapeCell("serve", "prefill", total, SERVE["batch"]))["tokens"]

    with first_calls() as seen:                           # warm-up
        generate(api, tokens, SERVE["prompt_len"], 2)
    args, kw, (o, lse) = seen["flash_attention_fwd"]
    o_p, lse_p = fa_k.flash_attention_plain(*args, **kw)
    on_path = {"flash_attention_fwd": max(
        within(o, o_p, FA_TOL["bfloat16"], "serve: flash_attention o"),
        within(lse, lse_p, FA_TOL["bfloat16"], "serve: flash_attention lse"))}
    args, kw, y = seen["ssd_scan"]
    on_path["ssd_scan"] = within(y, ssd_k.ssd_scan_plain(*args, **kw),
                                 SSD_TOL["bfloat16"], "serve: ssd_scan")
    del seen, args, kw, o, lse, o_p, lse_p, y

    torch.cuda.reset_peak_memory_stats()
    reset_serving_counts()                   # main path starts here
    out = generate(api, tokens, SERVE["prompt_len"], SERVE["gen"])
    counts = serving_counts()                # main path ends here
    peak = torch.cuda.max_memory_allocated()
    if counts != expected_counts(cfg):
        raise AssertionError(f"serve: (flash_attention, ssd_scan) launches "
                             f"{counts}, expected {expected_counts(cfg)}")
    logits = out.prefill_logits.float()
    if tuple(logits.shape) != (SERVE["batch"], cfg.vocab) or \
            not bool(logits.isfinite().all()):
        raise AssertionError("serve: prefill logits are not finite "
                             f"[batch, vocab]: {tuple(logits.shape)}")
    with plain_kernels():
        plain = generate(api, tokens, SERVE["prompt_len"], SERVE["gen"])
    bf16 = compare_paths(out, plain, SERVE_REL_TOL["bfloat16"], "bf16")
    api.model.cfg = dataclasses.replace(cfg, attn_impl="ref")
    ref = generate(api, tokens, SERVE["prompt_len"], 2)
    api.model.cfg = cfg
    bf16["ref_path_vs_plain_rel_err"] = float(
        (ref.prefill_logits.float() - plain.prefill_logits.float()).abs()
        .max() / plain.prefill_logits.float().abs().max())
    del api, out, plain, ref
    torch.cuda.empty_cache()

    # the same weights in float32: rounding no longer hides a kernel fault
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    api = build(cfg32, device=device, generator=torch.Generator(
        device=device).manual_seed(SERVE["param_seed"]))
    out32 = generate(api, tokens, SERVE["prompt_len"], SERVE["gen"])
    with plain_kernels():
        plain32 = generate(api, tokens, SERVE["prompt_len"], SERVE["gen"])
    f32 = compare_paths(out32, plain32, SERVE_REL_TOL["float32"], "float32")
    del api, out32, plain32
    torch.cuda.empty_cache()

    emit("serve", arch=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, params=n_params, param_dtype=cfg.param_dtype,
         batch=SERVE["batch"], prompt_len=SERVE["prompt_len"],
         gen=SERVE["gen"], init_s=init_s, prefill_s=bf16["prefill_s"],
         decode_s=bf16["decode_s"],
         decode_tokens_per_s=SERVE["batch"] * (SERVE["gen"] - 1)
         / bf16["decode_s"],
         max_memory_allocated=peak,
         launches={"flash_attention_fwd": counts[0], "ssd_scan": counts[1]},
         first_call_max_abs_err=on_path, kernel_vs_plain_bf16=bf16,
         kernel_vs_plain_float32=f32, tolerance=SERVE_REL_TOL)
    return {"cfg": cfg, "counts": counts}


def compare_paths(out, plain, tol, what) -> dict:
    """Kernel path against plain path: max |diff| of the prefill logits
    over max |logit| (raises above ``tol``), greedy agreement, times."""
    a, b = out.prefill_logits.float(), plain.prefill_logits.float()
    rel = float((a - b).abs().max() / b.abs().max())
    if not bool(a.isfinite().all()) or rel > tol:
        raise AssertionError(f"serve ({what}): kernel-path logits differ "
                             f"from the plain path by {rel} of max |logit| "
                             f"> {tol}")
    return {"logits_rel_err": rel,
            "greedy_tokens_equal_fraction":
                float((out.tokens == plain.tokens).float().mean()),
            "prefill_s": out.prefill_s, "decode_s": out.decode_s,
            "plain_prefill_s": plain.prefill_s,
            "plain_decode_s": plain.decode_s,
            "tokens_batch0": out.tokens[0].tolist()}


def kernel_row(name, source, replaces, launches, max_err, ms, plain_ms,
               n_bytes, n_flops, flops_per_s, library_ms, **extra) -> dict:
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_flops / flops_per_s * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "bytes": n_bytes, "flops": n_flops,
            **extra}


def time_serving_kernels(torch, device, serve, fa_check, ssd_check) -> list:
    """K2 and K5 at the shapes the full serve path launches them with."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.ssd_scan import kernel as ssd_k
    cfg = serve["cfg"]
    B, S = SERVE["batch"], SERVE["prompt_len"] + SERVE["gen"]
    H, KV, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    g = torch.Generator(device=device).manual_seed(300)
    bf16 = torch.bfloat16

    def model_layout(heads):     # [B, S, heads, hd] seen as [B, heads, S, hd]
        return torch.randn((B, S, heads, hd), generator=g,
                           device=device).to(bf16).transpose(1, 2)
    q, k, v = model_layout(H), model_layout(KV), model_layout(KV)
    ms = statistics.median(cuda_ms(
        lambda: fa_k.flash_attention_bhsd(q, k, v, causal=True), runs=20))
    plain_ms = statistics.median(cuda_ms(
        lambda: fa_k.flash_attention_plain(q, k, v, causal=True), runs=5))
    lib_ms = statistics.median(cuda_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
        runs=20))
    pairs = B * H * S * (S + 1) // 2          # causal (q, kv) pairs needed
    fa_bytes = 2 * (B * H * S * hd + 2 * B * KV * S * hd + B * H * S * hd) \
        + 4 * B * H * S
    fa_row = kernel_row(
        "flash_attention_fwd", FA_SOURCE, FA_REPLACES, serve["counts"][0],
        fa_check["max_abs_err"], ms, plain_ms, fa_bytes, 4 * hd * pairs,
        BF16_FLOPS_PER_S, lib_ms,
        shape={"B": B, "H": H, "KV": KV, "Sq": S, "Skv": S, "hd": hd,
               "causal": True, "dtype": "bfloat16"})

    nh = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    p, n, Q = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    L = -(-S // Q) * Q                        # ops.ssd_scan pads to chunks
    x, dt, A, Bm, Cm, D = ssd_inputs(torch, device, B, L, nh, p, n,
                                     "bfloat16", "bfloat16", seed=301)
    ms = statistics.median(cuda_ms(
        lambda: ssd_k.ssd_scan_chunked(x, dt, A, Bm, Cm, D, chunk=Q),
        runs=20))
    plain_ms = statistics.median(cuda_ms(
        lambda: ssd_k.ssd_scan_plain(x, dt, A, Bm, Cm, D, chunk=Q), runs=5))
    n_chunks = L // Q
    tri = Q * (Q + 1) // 2                    # (i, j) pairs with j <= i
    # matrix products a tensor-core design needs: C B^T once per (batch,
    # chunk), (C B^T o decay) x per head, C state and the state update
    ssd_flops = B * n_chunks * (tri * 2 * n + nh * (
        tri * 2 * p + 2 * Q * 2 * p * n))
    ssd_bytes = 2 * 2 * B * L * nh * p + 4 * B * L * nh + 2 * 2 * B * L * n \
        + 2 * 4 * nh
    ssd_row = kernel_row(
        "ssd_scan", SSD_SOURCE, SSD_REPLACES, serve["counts"][1],
        ssd_check["max_abs_err"], ms, plain_ms, ssd_bytes, ssd_flops,
        BF16_FLOPS_PER_S, None,
        shape={"b": B, "l": L, "h": nh, "p": p, "n": n, "chunk": Q,
               "dtype": "bfloat16"},
        operations_peak="bf16 tensor cores (989 TFLOP/s): the scan's "
                        "products are matrix products a redesign can run "
                        "on mma")
    return [fa_row, ssd_row]


def reset_training_counts():
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention import kernel_bwd as bwd_k
    fa_k.flash_attention_bhsd.launches = 0
    bwd_k.flash_attention_bwd_dq.launches = 0
    bwd_k.flash_attention_bwd_dkv.launches = 0


def training_counts() -> tuple:
    """(flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    launches."""
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention import kernel_bwd as bwd_k
    return (fa_k.flash_attention_bhsd.launches,
            bwd_k.flash_attention_bwd_dq.launches,
            bwd_k.flash_attention_bwd_dkv.launches)


def expected_train_counts(cfg) -> tuple:
    """Per step: the forward kernel in each layer's forward and again in its
    recompute (remat), each backward kernel once per layer."""
    n = cfg.n_layers
    return (2 * n if cfg.remat else n), n, n


def bwd_inputs(torch, device, shape, dtype, model, seed):
    """q, k, v, dO on the card (strided [B, S, heads, hd] views when
    ``model``) and the forward kernel's o, lse on them."""
    from repro_torch.kernels.flash_attention import kernel as fa_k
    B, H, KV, Sq, Skv, hd, causal = shape
    g = torch.Generator(device=device).manual_seed(seed)

    def make(heads, s):
        if model:
            return torch.randn((B, s, heads, hd), generator=g,
                               device=device).to(dtype).transpose(1, 2)
        return torch.randn((B, heads, s, hd), generator=g,
                           device=device).to(dtype)
    q, k, v, do = make(H, Sq), make(KV, Skv), make(KV, Skv), make(H, Sq)
    o, lse = fa_k.flash_attention_bhsd(q, k, v, causal=causal)
    return q, k, v, o, lse, do


def phase_bwd_check(torch, device) -> dict:
    """K3 and K4 against their plain version: tests/test_kernels.py's six
    shapes (GQA, ragged, Sq != Skv, causal and not), the model layout's
    strided views, both dtypes, the training shape; and two runs of each
    bit-equal."""
    from repro_torch.kernels.flash_attention import kernel_bwd as bwd_k
    shapes = [  # (B, H, KV, Sq, Skv, hd, causal)
        (1, 2, 2, 128, 128, 64, True),
        (2, 4, 2, 256, 256, 32, True),
        (1, 4, 1, 64, 192, 64, False),
        (1, 2, 2, 100, 100, 64, True),
        (2, 3, 1, 77, 130, 16, False),
        (1, 8, 2, 256, 100, 64, True),
        (1, 4, 2, 200, 70, 128, True),
        (1, 4, 4, 96, 96, 80, False),
        train_attention_shape(),
    ]
    cases, max_err = [], {"float32": 0.0, "bfloat16": 0.0}
    for i, shape in enumerate(shapes):
        for dt in ("float32", "bfloat16"):
            model = i % 2 == 1 or shape == train_attention_shape()
            q, k, v, o, lse, do = bwd_inputs(torch, device, shape,
                                             getattr(torch, dt), model,
                                             seed=400 + i)
            causal = shape[-1]
            before = training_counts()[1:]
            got = bwd_k.flash_attention_bwd_bhsd(q, k, v, o, lse, do,
                                                 causal=causal)
            again = bwd_k.flash_attention_bwd_bhsd(q, k, v, o, lse, do,
                                                   causal=causal)
            torch.cuda.synchronize()
            if training_counts()[1:] != (before[0] + 2, before[1] + 2):
                raise AssertionError("bwd_check: the backward wrappers did "
                                     "not launch their kernels")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"bwd_check: two runs differ at "
                                     f"{shape} {dt}")
            want = bwd_k.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                   causal=causal)
            what = f"flash_attention_bwd {dt} {shape}"
            err = max(within(g, w, BWD_TOL[dt], f"{what} d{n}")
                      for n, g, w in zip("qkv", got, want))
            max_err[dt] = max(max_err[dt], err)
            cases.append([*shape, model, dt, err])
            del q, k, v, o, lse, do, got, again, want
    emit("kernel_check", kernel="flash_attention_bwd (dq, dkv)",
         cases=len(cases), repeat_runs="bit-equal dq, dk, dv",
         tolerance={d: f"{t} abs + {t} rel, dq dk dv"
                    for d, t in BWD_TOL.items()},
         max_abs_err=max_err, detail=cases)
    return {"max_abs_err": max(max_err.values())}


def train_attention_shape() -> tuple:
    from repro_torch.configs.base import get_config
    cfg = get_config(TRAIN["arch"])
    return (TRAIN["batch"], cfg.n_heads, cfg.kv_heads, TRAIN["seq"],
            TRAIN["seq"], cfg.hd, True)


def smoke_train(torch, device, fx, cfg, supervised=None):
    """The three golden steps on the card; with ``supervised`` (a
    directory) under TrainSupervisor + CheckpointManager, a fault injected
    before step 2.  Returns ([(step, metrics)] in the order run, the final
    parameters, the (fwd, dq, dkv) launches, the restarts)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.convert import load_reference_params, tree_from_flat
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.models.api import build
    from repro_torch.runtime import TrainSupervisor
    n = len(fx["loss"])
    api = build(cfg, device=device)
    load_reference_params(api.model, tree_from_flat(fx, "param:"))
    opt = make_optimizer(cfg, total_steps=n)
    step_fn = make_train_step(api, opt)
    params = dict(api.model.named_parameters())
    state = {"params": params, "opt": opt.init(params)}
    log, armed = [], {"fault": supervised is not None}

    def one(state, i):
        if armed["fault"] and i == 2:
            armed["fault"] = False
            raise RuntimeError("injected fault")
        batch = {k: torch.from_numpy(fx[k][i]).to(device)
                 for k in ("tokens", "labels")}
        p, o, m = step_fn(state["params"], state["opt"], batch)
        log.append((i, {k: float(v) for k, v in m.items()}))
        return {"params": p, "opt": o}

    reset_training_counts()
    if supervised is None:
        for i in range(n):
            state = one(state, i)
        restarts = 0
    else:
        sup = TrainSupervisor(CheckpointManager(supervised), save_every=1)
        state, _ = sup.run(state, one, n)
        restarts = sup.restarts
    return log, state["params"], training_counts(), restarts


def phase_train_golden(torch, np, device) -> None:
    """Three training steps of the TinyLlama smoke config on the card, with
    the kernels, against the JAX reference's; then the same steps under the
    supervisor with a fault at step 2: the losses must be bit-equal."""
    import tempfile

    from repro_torch.configs.base import get_config
    from repro_torch.convert import export_params, tree_from_flat

    fx = dict(np.load(GOLDEN_TRAIN))
    cfg = dataclasses.replace(get_config(TRAIN["arch"], smoke=True),
                              attn_impl="flash", param_dtype="float32")
    log, params, counts, _ = smoke_train(torch, device, fx, cfg)
    n = len(fx["loss"])
    errs = {}
    for k in ("loss", "grad_norm", "lr"):
        got = np.array([m[k] for _, m in log])
        errs[k] = float(np.max(np.abs(got - fx[k]) / np.abs(fx[k])))
        if not np.isfinite(got).all() or errs[k] > TRAIN_GOLDEN_TOL[k]:
            raise AssertionError(f"train_golden: {k} {got.tolist()} differs "
                                 f"from the JAX reference {fx[k].tolist()} "
                                 f"by {errs[k]} relative")
    want = tree_from_flat(fx, "final:")
    got = export_params(params)
    tol = TRAIN_GOLDEN_TOL["params"]
    p_err = 0.0
    for key, w, g in _paired_leaves(want, got):
        d = np.abs(g - w)
        if (d > tol + tol * np.abs(w)).any():
            raise AssertionError(f"train_golden: parameter {key} after {n} "
                                 f"steps differs by {float(d.max())}")
        p_err = max(p_err, float(d.max()))
    per_step = expected_train_counts(cfg)
    if counts != tuple(n * c for c in per_step):
        raise AssertionError(f"train_golden: launches {counts}, expected "
                             f"{n} x {per_step}")
    with tempfile.TemporaryDirectory() as tmp:
        replay, _, _, restarts = smoke_train(torch, device, fx, cfg,
                                             supervised=tmp)
    clean = {i: m["loss"] for i, m in log}
    if restarts != 1 or [i for i, _ in replay] != [0, 1, 2] or \
            any(m["loss"] != clean[i] for i, m in replay):
        raise AssertionError(f"train_golden: replay after the fault "
                             f"{replay} != uninterrupted {clean}")
    emit("train_golden", config="tinyllama smoke, attn_impl=flash, float32",
         steps=n, batch=int(fx["tokens"].shape[1]),
         seq=int(fx["tokens"].shape[2]),
         loss=[m["loss"] for _, m in log],
         rel_err=errs, params_max_abs_err=p_err,
         tolerance=TRAIN_GOLDEN_TOL,
         launches={"flash_attention_fwd": counts[0],
                   "flash_attention_bwd_dq": counts[1],
                   "flash_attention_bwd_dkv": counts[2]},
         replay={"fault_before_step": 2, "restarts": restarts,
                 "steps_run": [i for i, _ in replay],
                 "losses_bit_equal": True})


def _paired_leaves(want, got, prefix=""):
    for k, w in want.items():
        if isinstance(w, dict):
            yield from _paired_leaves(w, got[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", w, got[k]


def loss_and_grads(torch, api, batch):
    """(loss, {name: grad}) of one forward and backward."""
    params = dict(api.model.named_parameters())
    loss = api.loss(batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def grad_distance(torch, got, want) -> dict:
    """max over leaves of |got - want| / |want| in 2-norm, and the loss's
    relative difference."""
    (l_g, g_g), (l_w, g_w) = got, want
    worst, leaf = 0.0, None
    for name, w in g_w.items():
        d = float(torch.linalg.vector_norm((g_g[name] - w).float())
                  / torch.linalg.vector_norm(w.float()).clamp_min(1e-30))
        if d > worst:
            worst, leaf = d, name
    return {"loss_rel_err": abs(float(l_g) - float(l_w)) / abs(float(l_w)),
            "grad_max_rel_2norm_err": worst, "worst_leaf": leaf}


def phase_train(torch, device) -> dict:
    """TinyLlama-1.1B at full width and depth, random weights from a seed,
    five AdamW steps with the kernels (the main path).  Checks: finite
    losses and gradient norms; the launches per step; each kernel's first
    call on the path against its plain version; then one step's loss and
    gradients against the plain path, in bf16 (ungated, beside a second
    plain implementation) and with the same weights in float32 (gated)."""
    from repro_torch.configs.base import ShapeCell, get_config
    from repro_torch.data import SyntheticLMDataset, to_device
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention import kernel_bwd as bwd_k
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.models.api import build

    cfg = dataclasses.replace(get_config(TRAIN["arch"]), attn_impl="flash")
    shape = ShapeCell("train", "train", TRAIN["seq"], TRAIN["batch"])
    t0 = time.perf_counter()
    api = build(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(TRAIN["param_seed"]))
    opt = make_optimizer(cfg, total_steps=TRAIN["steps"])
    step_fn = make_train_step(api, opt)
    params = dict(api.model.named_parameters())
    state = opt.init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.values())
    ds = SyntheticLMDataset(cfg, shape, seed=TRAIN["data_seed"])
    batches = [to_device(ds.get_batch(i), device)
               for i in range(TRAIN["steps"])]

    torch.cuda.reset_peak_memory_stats()
    steps, per_step = [], []
    reset_training_counts()                  # main path starts here
    with first_calls() as seen:
        for i, batch in enumerate(batches):
            c0 = training_counts()
            torch.cuda.synchronize()
            ts = time.perf_counter()
            params, state, m = step_fn(params, state, batch)
            torch.cuda.synchronize()
            steps.append({"step_s": time.perf_counter() - ts,
                          "loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"]),
                          "lr": float(m["lr"])})
            per_step.append([a - b for a, b in zip(training_counts(), c0)])
    counts = training_counts()               # main path ends here
    peak = torch.cuda.max_memory_allocated()
    want = list(expected_train_counts(cfg))
    if any(c != want for c in per_step):
        raise AssertionError(f"train: (fwd, dq, dkv) launches per step "
                             f"{per_step}, expected {want}")
    if not all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
               for s in steps):
        raise AssertionError(f"train: non-finite loss or grad norm {steps}")

    args, kw, (o, lse) = seen["flash_attention_fwd"]
    o_p, lse_p = fa_k.flash_attention_plain(*args, **kw)
    on_path = {"flash_attention_fwd": max(
        within(o, o_p, FA_TOL["bfloat16"], "train: flash_attention o"),
        within(lse, lse_p, FA_TOL["bfloat16"], "train: flash_attention lse"))}
    args, kw, grads = seen["flash_attention_bwd"]
    want_g = bwd_k.flash_attention_bwd_plain(*args, **kw)
    on_path["flash_attention_bwd"] = max(
        within(g, w, BWD_TOL["bfloat16"], f"train: flash_attention d{n}")
        for n, g, w in zip("qkv", grads, want_g))
    del seen, args, kw, o, lse, o_p, lse_p, grads, want_g

    # bf16, the trained weights, step 0's batch: kernel path, plain path,
    # and the reference's non-kernel path (attn_impl="ref") as a second
    # plain implementation
    del state, step_fn
    torch.cuda.empty_cache()
    batch = batches[0]
    kern = loss_and_grads(torch, api, batch)
    with plain_kernels():
        plain = loss_and_grads(torch, api, batch)
    bf16 = grad_distance(torch, kern, plain)
    del kern
    api.model.cfg = dataclasses.replace(cfg, attn_impl="ref")
    ref = loss_and_grads(torch, api, batch)
    api.model.cfg = cfg
    bf16["ref_path_vs_plain"] = grad_distance(torch, ref, plain)
    del api, params, plain, ref
    torch.cuda.empty_cache()

    # the same weights in float32: rounding no longer hides a kernel fault
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    api = build(cfg32, device=device, generator=torch.Generator(
        device=device).manual_seed(TRAIN["param_seed"]))
    torch.cuda.synchronize()
    ts = time.perf_counter()
    kern = loss_and_grads(torch, api, batch)
    torch.cuda.synchronize()
    kern_s = time.perf_counter() - ts
    ts = time.perf_counter()
    with plain_kernels():
        plain = loss_and_grads(torch, api, batch)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - ts
    f32 = grad_distance(torch, kern, plain)
    f32.update(kernel_path_s=kern_s, plain_path_s=plain_s)
    del api, kern, plain, batches, batch
    torch.cuda.empty_cache()
    if f32["loss_rel_err"] > TRAIN_REL_TOL["loss"] or \
            f32["grad_max_rel_2norm_err"] > TRAIN_REL_TOL["grad"]:
        raise AssertionError(f"train (float32): kernel path differs from the "
                             f"plain path: {f32}, tolerance {TRAIN_REL_TOL}")

    times = [s["step_s"] for s in steps]
    steady = statistics.median(times[1:])
    emit("train", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         params=n_params, param_dtype=cfg.param_dtype, remat=cfg.remat,
         batch=TRAIN["batch"], seq=TRAIN["seq"], init_s=init_s,
         first_step_s=times[0], median_step_s_2_to_5=steady,
         tokens_per_s=TRAIN["batch"] * TRAIN["seq"] / steady,
         steps=steps, max_memory_allocated=peak,
         launches={"flash_attention_fwd": counts[0],
                   "flash_attention_bwd_dq": counts[1],
                   "flash_attention_bwd_dkv": counts[2]},
         launches_per_step=per_step, expected_per_step=want,
         first_call_max_abs_err=on_path, kernel_vs_plain_bf16=bf16,
         kernel_vs_plain_float32=f32, tolerance=TRAIN_REL_TOL)
    return {"counts": counts}


def time_training_kernels(torch, device, train, bwd_check, fa_row) -> list:
    """K3 and K4 at the shape the training path launches them with; SDPA's
    backward (GQA) as the one library call computing both.  K2's time at
    that shape goes into its row (``train``) beside its serving numbers."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention import kernel_bwd as bwd_k
    shape = train_attention_shape()
    B, H, KV, S, _, hd, causal = shape
    q, k, v, o, lse, do = bwd_inputs(torch, device, shape, torch.bfloat16,
                                     True, seed=500)
    pairs = B * H * S * (S + 1) // 2          # causal (q, kv) pairs needed
    rows = B * H * S * hd * 2                 # one bf16 [B, H, S, hd]
    kv = B * KV * S * hd * 2
    fwd = kernel_row(
        "flash_attention_fwd", FA_SOURCE, FA_REPLACES, train["counts"][0],
        fa_row["max_abs_err"],
        statistics.median(cuda_ms(
            lambda: fa_k.flash_attention_bhsd(q, k, v, causal=True),
            runs=20)),
        statistics.median(cuda_ms(
            lambda: fa_k.flash_attention_plain(q, k, v, causal=True),
            runs=5)),
        2 * rows + 2 * kv + 4 * B * H * S, 4 * hd * pairs, BF16_FLOPS_PER_S,
        statistics.median(cuda_ms(
            lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), runs=20)))
    # K2's row keeps its serving-shape numbers; these are the training's
    fa_row["train"] = {key: fwd[key] for key in (
        "launches", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    fa_row["train"]["shape"] = {"B": B, "H": H, "KV": KV, "Sq": S, "Skv": S,
                                "hd": hd, "causal": causal,
                                "dtype": "bfloat16"}
    _, delta = bwd_k.flash_attention_bwd_dq(q, k, v, o, lse, do)
    dq_ms = statistics.median(cuda_ms(
        lambda: bwd_k.flash_attention_bwd_dq(q, k, v, o, lse, do), runs=20))
    dkv_ms = statistics.median(cuda_ms(
        lambda: bwd_k.flash_attention_bwd_dkv(q, k, v, do, lse, delta),
        runs=20))
    dq_plain = statistics.median(cuda_ms(
        lambda: bwd_k.bwd_dq_plain(q, k, v, o, lse, do), runs=5))
    dkv_plain = statistics.median(cuda_ms(
        lambda: bwd_k.bwd_dkv_plain(q, k, v, do, lse, delta), runs=5))
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                         enable_gqa=True)
    lib_ms = statistics.median(cuda_ms(
        lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
        runs=20))
    common = dict(shape={"B": B, "H": H, "KV": KV, "Sq": S, "Skv": S,
                         "hd": hd, "causal": causal, "dtype": "bfloat16"},
                  library_call="backward of F.scaled_dot_product_attention("
                               "is_causal=True, enable_gqa=True): one "
                               "number for K3 + K4 together")
    err = bwd_check["max_abs_err"]
    # K3 reads q, o, dO, k, v, lse and writes dq, delta; K4 reads q, dO, k,
    # v, lse, delta and writes the per-query-head dk, dv
    dq_row = kernel_row(
        "flash_attention_bwd_dq", BWD_SOURCE, DQ_REPLACES, train["counts"][1],
        err, dq_ms, dq_plain, 4 * rows + 2 * kv + 2 * 4 * B * H * S,
        6 * hd * pairs, BF16_FLOPS_PER_S, lib_ms, **common)
    dkv_row = kernel_row(
        "flash_attention_bwd_dkv", BWD_SOURCE, DKV_REPLACES,
        train["counts"][2], err, dkv_ms, dkv_plain,
        4 * rows + 2 * kv + 2 * 4 * B * H * S, 8 * hd * pairs,
        BF16_FLOPS_PER_S, lib_ms, **common)
    return [dq_row, dkv_row]


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:   # one nvcc per source
        libs = dict(zip(SOURCES, pool.map(_build.build, SOURCES)))
    emit("build", kernels=list(SOURCES), seconds=time.perf_counter() - t0,
         ptxas={name: [ln.strip() for ln in
                       lib.with_suffix(".log").read_text().splitlines()
                       if "registers" in ln or "spill" in ln]
                for name, lib in libs.items()})


def check_report_against_golden(report, entry) -> int:
    """Counts and capacity fractions of a session report against one entry
    of the golden file; returns the number of events."""
    events = 0
    for name, g in entry["subpartitions"].items():
        rep = report["subpartitions"][name]
        for key in ("n_reads", "n_writes", "n_lifetimes", "unique_addrs"):
            if rep[key] != g[key]:
                raise AssertionError(
                    f"{name}.{key}: {rep[key]} != golden {g[key]}")
        comp = rep["composition"]
        if comp["devices"] != g["composition_devices"] or \
                comp["capacity_fractions"] != g["capacity_fractions"]:
            raise AssertionError(
                f"{name}: composition {comp['capacity_fractions']} != "
                f"golden {g['capacity_fractions']}")
        events += rep["n_reads"] + rep["n_writes"]
    if events != entry["n_events"]:
        raise AssertionError(
            f"{events} events, golden has {entry['n_events']}")
    return events


def phase_cli(golden) -> None:
    """The profile CLI on the card (2 layers, the registry default)."""
    from repro_torch.__main__ import main as cli_main
    out = ROOT / "build" / "chip_smoke_cli_report.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rc = cli_main(["profile", "--arch", "tinyllama_1_1b", "--backend",
                       "systolic", "--pe", "128", "--out", str(out)])
    if rc != 0:
        raise AssertionError(f"profile CLI returned {rc}")
    events = check_report_against_golden(json.loads(out.read_text()),
                                         golden["entries"]["2"])
    emit("cli", events=events, seconds=time.perf_counter() - t0,
         golden="n_layers=2 entry: counts and capacity fractions equal")


def phase_full(torch, np, device, golden) -> dict:
    """The main path at full width and depth; returns what the timing
    phase needs (launch count, the largest sorted subpartition)."""
    import math

    from repro_torch.core import ProfileSession
    from repro_torch.core.lifetime import (lifetimes_of_trace,
                                           sort_by_addr_time)
    from repro_torch.kernels.lifetime_scan import kernel as k
    from repro_torch.kernels.lifetime_scan.ops import (default_edges,
                                                       integer_edges,
                                                       lifetime_histogram)
    from repro_torch.workloads import get_workload

    run = golden["run"]
    entry = golden["entries"][str(FULL_LAYERS)]
    ie = integer_edges(default_edges())

    torch.cuda.reset_peak_memory_stats()
    k.lifetime_scan_sorted.launches = 0          # main path starts here

    workload, cfg = get_workload(run["arch"]).with_params(
        seq=run["seq"], n_layers=FULL_LAYERS).build(run["backend"])
    session = ProfileSession(run["backend"])
    t0 = time.perf_counter()
    session.profile(workload, rows=run["pe"], cols=run["pe"],
                    dataflow=run["dataflow"], **cfg)
    t1 = time.perf_counter()
    session.analyze()           # ends with host copies: the card is idle
    t2 = time.perf_counter()
    session.compose()
    t3 = time.perf_counter()
    report = session.report()
    trace = session.trace

    kernel_s = extract_s = 0.0
    biggest = None
    for sub, name in enumerate(trace.names):
        t_sub = trace.select(sub)
        # the device share of analyze(), timed again on its own: copy to
        # the card, two sorts, segment reductions (analyze() also selects
        # the subpartition and builds its statistics on the host)
        te = time.perf_counter()
        lifetimes_of_trace(t_sub)
        torch.cuda.synchronize()
        extract_s += time.perf_counter() - te
        tk = time.perf_counter()
        hist, stats = lifetime_histogram(t_sub.time_cycles, t_sub.addr,
                                         t_sub.is_write)
        hist, stats = hist.cpu().numpy(), stats.cpu().tolist()
        kernel_s += time.perf_counter() - tk

        # against the session's own lifetimes, binned on the host
        _, raw = session.subpartition_stats(name)
        host = raw.numpy()
        lt = host.lifetime_cycles[~host.orphan]
        bins = np.searchsorted(ie, lt, side="right") - 1
        want_hist = np.bincount(bins[(bins >= 0) & (bins < len(ie) - 1)],
                                minlength=len(ie) - 1)
        n_reads, n_writes = t_sub.counts()
        want = [len(lt), int(host.orphan.sum()), int(lt.sum()),
                int(lt.max()) if len(lt) else 0, n_reads, n_writes, 0, 0]
        if stats != want or not np.array_equal(hist, want_hist):
            raise AssertionError(
                f"{name}: kernel stats {stats} != session {want}")
        # against the golden file of the JAX reference
        g = entry["subpartitions"][name]
        if stats != [g["live"], g["orphans"], g["sum_lt"], g["max_lt"],
                     g["n_reads"], g["n_writes"], 0, 0] or \
                hist.tolist() != g["hist"]:
            raise AssertionError(f"{name}: kernel result != golden file")
        if biggest is None or t_sub.n_events > biggest.n_events:
            biggest = t_sub

    launches = k.lifetime_scan_sorted.launches   # main path ends here
    check_report_against_golden(report, entry)
    for name, rep in report["subpartitions"].items():
        comp = rep["composition"]
        vals = [rep["duration_s"], rep["mean_lifetime_s"],
                comp["energy_vs_sram"], comp["area_vs_sram"]]
        if not all(math.isfinite(v) for v in vals) or \
                abs(sum(comp["capacity_fractions"]) - 1.0) > 1e-9:
            raise AssertionError(f"{name}: report is not finite/normalised")
    if launches < len(trace.names):
        raise AssertionError(
            f"lifetime_scan launched {launches} time(s) on the main path, "
            f"expected one per subpartition ({len(trace.names)})")

    emit("full", arch=run["arch"], n_layers=FULL_LAYERS, seq=run["seq"],
         pe=run["pe"], dataflow=run["dataflow"], events=trace.n_events,
         subpartition_events={n: int((trace.subpartition == i).sum())
                              for i, n in enumerate(trace.names)},
         host_profile_s=t1 - t0, analyze_s=t2 - t1,
         device_extract_s=extract_s, host_compose_s=t3 - t2,
         kernel_entry_s=kernel_s,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         lifetime_scan_launches=launches,
         golden=f"n_layers={FULL_LAYERS} entry: counts, histogram, "
                "sum_lt, max_lt and capacity fractions equal")

    t = torch.from_numpy(biggest.time_cycles).to(device)
    a = torch.from_numpy(biggest.addr).to(device)
    w = torch.from_numpy(biggest.is_write).to(device)
    order = sort_by_addr_time(t, a)
    return {"launches": launches,
            "sorted": (t[order], a[order], w[order]),
            "edges": torch.from_numpy(ie).to(device)}


def time_lifetime_scan(torch, full, check) -> dict:
    """K1 at the largest subpartition of the full-depth profiling path."""
    from repro_torch.kernels.lifetime_scan import kernel as k
    t, a, w = full["sorted"]
    edges = full["edges"]
    n, n_bins = t.shape[0], edges.shape[0] - 1

    ms = statistics.median(cuda_ms(
        lambda: k.lifetime_scan_sorted(t, a, w, edges), runs=20))
    plain_ms = statistics.median(cuda_ms(
        lambda: k.lifetime_scan_plain(t, a, w, edges), runs=5))
    hist, stats = k.lifetime_scan_sorted(t, a, w, edges)
    n_segments = int(stats[0] + stats[1])
    live = int(stats[0])

    # bytes: every input read once, every output written once
    n_bytes = n * (8 + 8 + 1) + (n_bins + 1) * 8 + n_bins * 8 + 8 * 8
    # operations this data needs: two compares per event for the boundary,
    # one subtraction and a binary search over the edges per live segment,
    # one count per segment
    n_ops = 2 * n + live * (1 + (n_bins + 1).bit_length()) + n_segments
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / INT_OPS_PER_S * 1e3
    row = {
        "name": "lifetime_scan", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": full["launches"],
        "max_abs_err": check["max_abs_err"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "events": n, "segments": n_segments, "bytes": n_bytes,
    }
    return row


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
              "is false", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.device import default_device

    device = default_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    # float32 products in full float32 on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()

    golden = json.loads(GOLDEN.read_text())
    check = phase_kernel_check(torch, device)
    fa_check = phase_fa_check(torch, device)
    ssd_check = phase_ssd_check(torch, device)
    phase_cli(golden)
    full = phase_full(torch, np, device, golden)
    bwd_check = phase_bwd_check(torch, device)
    phase_golden(torch, np, device)
    serve = phase_serve(torch, device)
    phase_train_golden(torch, np, device)
    train = phase_train(torch, device)
    rows = [time_lifetime_scan(torch, full, check)]
    rows += time_serving_kernels(torch, device, serve, fa_check, ssd_check)
    rows += time_training_kernels(torch, device, train, bwd_check, rows[1])
    print(json.dumps({"kernels": rows}), flush=True)

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
