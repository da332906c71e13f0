#!/usr/bin/env python3
"""On-GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and no network; exits non-zero without a
GPU.  It builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
per source, all at once), holds each kernel against its plain PyTorch
version on the card, and drives the port's two paths:

* profiling: the profile CLI, then profile -> analyze -> compose at the full
  width and depth of TinyLlama-1.1B (composition by the policy kernels B7,
  the default engine) and the ``lifetime_scan`` entry point on the traces
  the session profiled, checked against the session's own lifetimes and the
  golden file written from the JAX reference;
* GPU-cache profiling: ``ProfileSession("gpu")`` -> analyze -> compose on
  TinyLlama-1.1B's op stream at full width and depth (22 layers, seq 128,
  line sampling 8) and on every ``mlperf`` workload, the L1 and L2 replays
  on the card by the ``cache_replay`` kernels (two wrapper calls per run,
  each the split replay's three CUDA launches under write-allocate) and the
  composition by B7 (one launch per subpartition), each run held against
  ``golden_gpu_cachesim.json`` written from the JAX reference (trace
  digests, counts, histograms, capacity fractions);
* the design-space sweep, beside each profiling path and before its
  session is freed: ``ProfileSession.sweep`` on the analyzed full-depth
  session, ``engine="torch"`` (the
  policy kernels B7 on the card) against ``engine="numpy"`` for
  refresh-free, refresh-aware and bank-quantized on the CLI's default grid
  (capacity fractions bit-identical, energy within 1e-9), a 73-candidate
  grid timed, against numpy on the path's 2-layer session, and the sweep
  CLI's dry run; after the systolic sweep its session is freed and the
  composition memos are checked to hold nothing of it;
* the contract analyzer: ``python -m repro_torch check --format json`` over
  the checkout's tree (clean, five rules), then ``devices`` and
  ``workloads`` with torch and numpy blocked and ``campaign --dry-run``
  with torch blocked, each in an interpreter of its own;
* campaigns, once the GPU-cache session is freed: ``CampaignRunner`` on the
  paper's MLPerf + PolyBench suites x ``systolic,gpu`` at registry
  parameters with four threads (every ``gpu`` job two B6 calls, every
  compose and sweep B7), each job's facts and the cross-suite aggregate
  held against ``golden_campaign.json`` written from the JAX reference, a
  warm rerun that executes nothing, and the process scheduler (two
  ``python -m repro_torch worker`` processes on a subset) with artifacts
  byte-identical to the thread scheduler's;
* the graph-walking backend, once the campaign is done:
  ``ProfileSession("tpu")`` on the own training steps of TinyLlama-1.1B,
  Zamba2-2.7B, deepseek-moe-16b, phi3.5-moe, InternVL2-1B and
  Whisper-small at full width and depth (seq 128, batch 1, the ``archs``
  lowering's sample 4), captured as aten graphs over meta tensors (no device
  memory, no kernel launch), analyzed on the card and composed by B7
  against the numpy engine (capacity bit-identical, energy within 1e-9);
  before it, K5's missing backward: a gradient through ``ops.ssd_scan``
  on the card raises;
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
  plain versions in float32;
* the MoE, VLM and audio families: their smoke configs in float32 against
  the JAX reference's golden fixtures (``family_golden``), then
  deepseek-moe-16b, InternVL2-1B and Whisper-small as published, served
  (two deepseek-moe-16b prefills bit-equal) and trained for three steps
  (deepseek-moe-16b at full width and 4 layers), with the flash-attention
  kernels launched as often as the config says and no plain-version call,
  and one float32 step of each at reduced depth, kernel path against plain
  path (``families``);
* the tuned configs (``tuned``): ``get_tuned_config`` on TinyLlama-1.1B as
  published (flashref attention, save_proj_remat, tp_bf16_reduce), served
  at batch 4 x (1008 + 16) through qchunk with decode_inplace off and on
  (equal tokens, bit-equal logits, the in-place steps return the cache
  they were given; decode tokens/s, the decode loop's peak memory and one
  decode step's device split from a ``torch.profiler`` trace in a fresh
  interpreter), trained five steps at batch 4 x 2048 with save_proj_remat
  and with plain remat (step s, tokens/s, the peak difference beside the
  two projections' predicted bytes), float32 steps at two layers
  (save_proj_remat = plain remat within 1e-6; the tuned step against the
  untuned ``attn_impl="ref"`` one), and the ten arch configs' tuned smoke
  configs against the JAX reference's ``golden_tuned_<arch>.npz``; no
  kernel launches on this path and no plain version runs;
* the mesh (``mesh``): ``launch.train.main`` on TinyLlama-1.1B as
  published (bf16, flash attention, batch 4 x 2048, three steps) and
  ``launch.serve.main`` on Zamba2-2.7B as published (flash, batch 4,
  prompt 1008 + 16), each with ``--mesh host`` (a (1, 1) DeviceMesh over
  a world of one, NCCL; parameters, optimizer state, batch and caches as
  DTensors, K2-K5 through ``local_map``) beside ``--mesh none``: the same
  K2/K3/K4/K5 launch counts and no plain-version call, losses within
  2e-3 relative, equal tokens, no process group left afterwards.  One
  card shows no multi-rank sharding; the CPU gloo tests do;
* the dry-run (``dryrun``): ``launch.dryrun.run_cell`` on three cells of
  the production grid, each over a fake world of 256 or 512 ranks in this
  process with meta DTensors on a ``cuda`` mesh: TinyLlama-1.1B
  ``train_4k`` on 16x16, Zamba2-2.7B ``long_500k`` on 16x16 (the SSM state
  placed by batch, the attention caches split by sequence at batch 1) and
  deepseek-moe-16b ``train_4k`` on 2x16x16; each cell ``ok``, its
  ``n_params`` and ``model_flops`` equal to ``golden_dryrun.json``
  (written from the JAX reference), device memory unchanged across the
  phase, no kernel launch or plain-version call, no process group left.

It times each kernel at the shapes its path gives it: the lifetime scan
right after the profiling path (also on one segment that crosses every
range of the kernel and on a random trace of the same length), the cache
replay right after the GPU-cache path (at its L1 and L2 shapes, on a
1 M-event mixed stream and on 1 M accesses in one set), the policy kernels
after the sweep (at the 73-candidate grid on the full-depth systolic
subpartition), the others after training (the attention kernels also at
the families' training shapes, beside SDPA).

Output: the ``nvidia-smi`` name/power-limit line, then one JSON object per
phase (``device``, ``build`` with each kernel's registers, spills and
tensor-core instructions in its SASS, ``kernel_check`` per kernel (the
lifetime scan's on random and structured streams, the cache replay's on
random, skewed, empty, near-2^59 and mixed streams, set counts at S - 1, S
and S + 1 and 1 M accesses in one set, the policy kernels' on random grids
and address structures), ``cli``, ``check``, ``full``, ``sweep`` of the
systolic session, ``gpu``, ``sweep`` of the GPU-cache session,
``campaign``, ``tpu``, ``golden``, ``serve``, ``train_golden``, ``train``,
``family_golden``, ``families``, ``tuned``, ``mesh``, ``dryrun``;
``ssd_no_backward`` after K5's ``kernel_check``), then the ``walls``
line (each phase's wall seconds), then the ``kernels`` line, then
``{"ok": true, "device": {...}}`` as the last line.
Any failed phase raises: nothing is caught, nothing falls back to the CPU or
to a plain version.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import weakref
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
# K1's single-segment case and its timing: the full-depth TinyLlama
# subpartition's event count
LONG_SEGMENT_EVENTS = 11_185_152
SOURCES = ("lifetime_scan", "flash_attention_fwd", "ssd_scan",
           "flash_attention_bwd", "cache_replay", "compose_policy")
FA_SOURCE = "src/repro_torch/csrc/flash_attention_fwd.cu"
FA_REPLACES = "src/repro/kernels/flash_attention/kernel.py:26"
SSD_SOURCE = "src/repro_torch/csrc/ssd_scan.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan/kernel.py:23"
GOLDEN_ZAMBA2 = ROOT / "tests" / "fixtures" / "torch" / \
    "golden_zamba2_smoke.npz"
GOLDEN_GPU = ROOT / "tests" / "fixtures" / "torch" / \
    "golden_gpu_cachesim.json"
B6_SOURCE = "src/repro_torch/csrc/cache_replay.cu"
B6_REPLACES = "src/repro/backends/cachesim.py:143"
# the GPU-cache path's main run: the golden entry at TinyLlama's own depth
GPU_MAIN = "tinyllama_1_1b@22"
# B6's kernel_check: ways (8 and 16 have their own kernel, the others the
# 32-wide one) by n_sets, events per case capped so that the plain
# version's slot loop stays short
B6_WAYS = (1, 2, 3, 4, 8, 16, 32)
B6_SETS = (1, 8, 128, 2048, 4096)
B6_MAX_SLOTS = 2000
# B6's kernels by name in a profiler trace: the split replay's three
# (write-allocate) and the per-set chain (no-write-allocate)
B6_SPLIT_KERNELS = ("split_summary_kernel", "split_replay_kernel",
                    "split_resolve_kernel")
B6_CHAIN_KERNEL = "cache_replay_kernel"
PROFILED_KERNELS = ("lifetime_scan_kernel", *B6_SPLIT_KERNELS,
                    B6_CHAIN_KERNEL)
# B6's one-set case: 1 M accesses over 64 lines of one of 128 sets
B6_ONE_SET = {"n": 1_000_000, "lines": 64, "n_sets": 128, "ways": 8}
# the 1 M-event stream of benchmarks/cachesim_bench.py (_mixed_stream)
# B7 (compose_policy) against its plain version on the card
B7_ENERGY_RTOL = 1e-15
# floor sums are integer counts times integer block bits: below 2**53 every
# partial sum is an exact integer, so they are compared exactly there
B7_FLOOR_EXACT_BELOW = 2.0 ** 53
B7_TOLERANCE = (f"counts, picks, per-address refresh sums and floor sums "
                f"below 2**53 exact, energy {B7_ENERGY_RTOL} relative")
B7_SOURCE = "src/repro_torch/csrc/compose_policy.cu"
B7_RF_REPLACES = "src/repro/compose/executor.py:272"
B7_RA_REPLACES = "src/repro/compose/executor.py:312"
B7_UNGROUPED_REPLACES = "src/repro/compose/executor.py:351"
FP64_FLOPS_PER_S = 34e12         # H100 SXM fp64 outside the tensor cores
# B7's rows on the kernels line: each kernel's wrapper and its key in
# b7_counts() (the retention pass also gives the monolithic baselines)
B7_LAUNCH_KEYS = {"compose_policy_rf": "rf",
                  "compose_policy_retention": "retention",
                  "compose_policy_ra_grouped": "ra_grouped",
                  "compose_policy_ra_decide": "ra_decide",
                  "compose_policy_ra_ungrouped": "ra_ungrouped"}
# the campaign phase: the paper's MLPerf + PolyBench campaign on the card
# against the reference's golden facts; the process scheduler on a subset
GOLDEN_CAMPAIGN = ROOT / "tests" / "fixtures" / "torch" / \
    "golden_campaign.json"
CAMPAIGN_THREADS = 4
CAMPAIGN_RTOL = 1e-9
CAMPAIGN_PROCESS = {"workloads": "polybench-2mm,bert-base-uncased",
                    "workers": 2}
# fp64 operations the bounds count: a refresh-aware energy per (candidate,
# device, lifetime or address) (2 products and 2 sums of energy_fj, the
# refresh term's product, the comparison, the minimum), the retention
# pass's per (retention, lifetime) with addresses (division, ceil,
# subtraction, maximum, product, sum) and without (division, floor,
# product, sum), the candidate pass's recompute of the refresh bits
# (division, ceil, subtraction, maximum, product)
B7_OPS_ENERGY = 7
B7_OPS_RETENTION = 6
B7_OPS_FLOOR = 4
B7_OPS_REFRESH = 5
# B7 before the retention index (the per-candidate kernels): 8 fp64
# operations per real (candidate, device, lifetime), its old bound
B7_OPS_OLD = 8
# the sweep phase: the CLI's default grid (4 candidates, D <= 4) and the
# wide grid (73 candidates, D = 4); torch against numpy
SWEEP_GRID = {"mixes": (0.0, 0.5, 1.0), "retention_scales": (0.5, 1.0, 2.0)}
SWEEP_WIDE_GRID = {"mixes": (0.0, 0.5, 1.0),
                   "retention_scales": (0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0,
                                        32.0),
                   "area_scales": (0.5, 1.0, 2.0),
                   "energy_scales": (0.5, 1.0, 2.0)}
SWEEP_POLICIES = ("refresh-free", "refresh-aware", "bank-quantized")
SWEEP_ENERGY_RTOL = 1e-9
MIXED = {"n": 1_000_000, "write_fraction": 0.35, "hot_lines": 2048,
         "sweep_lines": 1 << 20, "seed": 0}
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
# the tensor-core kernels the build must hold: templated on the head dim,
# and K5's two
MMA_KERNELS = ("flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel",
               "flash_bwd_dkv_mma_kernel")
SSD_MMA_KERNELS = ("ssd_chunk_state_mma_kernel", "ssd_chunk_scan_mma_kernel")
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
# the contract analyzer's rules, in its reporting order, and the limit on
# each command the check phase starts
CHECK_RULES = ("import-purity", "dtype-safety", "registry-conformance",
               "schema-drift", "atomic-write")
CHECK_TIMEOUT_S = 120
# the graph-walking backend on the framework's own training steps, at full
# width and depth, through the archs lowering (its sample 4)
TPU = {"archs": ("tinyllama_1_1b", "zamba2_2_7b", "deepseek_moe_16b",
                 "phi3_5_moe", "internvl2_1b", "whisper_small"),
       "seq": 128, "batch": 1, "tpu_smoke": False,
       "policies": ("refresh-free", "refresh-aware")}
TPU_ENERGY_RTOL = 1e-9
# the MoE, VLM and audio families at published widths (bf16, random weights
# from a seed, attn_impl="flash"): served at batch 4 (prompt + greedy
# tokens; InternVL2 adds its 256 vision embeddings, Whisper encodes 1500
# frames and serves its 448-token decoder context), then trained for three
# steps at batch 4 (deepseek-moe-16b at full width and 4 layers: 1 dense +
# 3 MoE; its 28 layers of training state do not fit one card)
FAMILY_ARCHS = ("deepseek_moe_16b", "internvl2_1b", "whisper_small")
FAMILY_SERVE = {"deepseek_moe_16b": (1008, 16), "internvl2_1b": (1008, 16),
                "whisper_small": (432, 16)}      # (prompt_len, gen)
FAMILY_TRAIN = {"deepseek_moe_16b": {"seq": 2048, "n_layers": 4},
                "internvl2_1b": {"seq": 2048}, "whisper_small": {"seq": 448}}
FAMILY_BATCH = 4
FAMILY_STEPS = 3
FAMILY_SEEDS = {"param": 0, "token": 1, "data": 0}
# the float32 step of each family on the kernel path against the plain path
# (TRAIN_REL_TOL), at full width, reduced depth and batch
FAMILY_F32 = {"n_layers": 2, "batch": 1}
# the attention shapes the families' training paths give K2, K3 and K4
# (B, H, KV, Sq, Skv, hd, causal): head dim 128, a GQA group of 7, the
# Whisper encoder's 1500 keys (not a multiple of the 64-row tile), no mask,
# and the Whisper decoder's 448-token causal self-attention
FAMILY_ATTENTION = {"deepseek_moe_16b": (4, 16, 16, 2048, 2048, 128, True),
                    "internvl2_1b": (4, 14, 2, 2304, 2304, 64, True),
                    "whisper_small encoder": (4, 12, 12, 1500, 1500, 64,
                                              False),
                    "whisper_small decoder": (4, 12, 12, 448, 448, 64,
                                              True)}
# the families' smoke configs on the card against the JAX reference's
# golden fixtures (tests/make_torch_golden.py --only families): float32
# prefill logits abs, one train step's loss and grad norm relative
FAMILY_GOLDEN_TOL = {"logits": 1e-4, "loss": 1e-5, "grad_norm": 1e-5,
                     "lr": 1e-6}
# get_tuned_config (flashref attention, save_proj_remat, tp_bf16_reduce) on
# TinyLlama-1.1B as published (bf16, seed 0): served at SERVE's batch and
# lengths with decode_inplace off and on (prefill through qchunk), trained
# at TRAIN's shape with save_proj_remat and with plain remat; then float32
# steps at full width and f32_layers layers.  No kernel of the table lies
# on this path: every wrapper's count stays 0 and no plain version runs.
TUNED = {"arch": "tinyllama_1_1b", "batch": 4, "prompt_len": 1008,
         "gen": 16, "seq": 2048, "steps": 5, "param_seed": 0,
         "token_seed": 1, "data_seed": 0, "profile_steps": 3,
         "f32_layers": 2, "f32_batch": 1}
# save_proj_remat against plain remat, float32: the loss and each gradient
# leaf relative (the same arithmetic; only what is kept differs)
TUNED_PROJ_REL_TOL = 1e-6
# save_proj_remat's forward keeps the two projections of every layer more
# than plain remat's: their bytes, within this share
TUNED_KEPT_REL_TOL = 0.01
# the tuned float32 step against the untuned attn_impl="ref" step:
# without tp_bf16_reduce within TRAIN_REL_TOL; with it (projection outputs
# rounded to bf16) the loss within TRAIN_REL_TOL and each gradient leaf
# within bf16's 2e-2
TUNED_BF16_REDUCE_REL_TOL = {"loss": TRAIN_REL_TOL["loss"], "grad": 2e-2}
# the ten tuned smoke configs (float32) against golden_tuned_<arch>.npz
# (tests/make_torch_golden.py --only tuned): without tp_bf16_reduce the
# families' float32 gates; as published the logits and grad norm, which
# pass through bf16-rounded projection outputs, as bf16 values
TUNED_GOLDEN_TOL = {"no_bf16_reduce": FAMILY_GOLDEN_TOL,
                    "tuned": {**FAMILY_GOLDEN_TOL, "logits": 2e-2,
                              "grad_norm": 2e-2}}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# each phase's wall seconds, in the order they ran
WALLS: dict = {}


def timed(name: str, fn, *args, **kwargs):
    t0 = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        WALLS[name] = WALLS.get(name, 0.0) + time.perf_counter() - t0


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


def segments_of(n, length, shift, torch, device):
    """A sorted stream of segments of exactly ``length`` events: a write
    at every index ``shift`` mod ``length``, then reads of one address."""
    i = torch.arange(n, device=device, dtype=torch.int64)
    return (3 * i + 2 ** 40, ((i - shift) // length) * 3 + 2 ** 31,
            (i - shift) % length == 0)


def long_segment(n, torch, device):
    """One write, then only reads, at one address: one segment that spans
    every range of the kernel."""
    i = torch.arange(n, device=device, dtype=torch.int64)
    return 3 * i + 2 ** 40, torch.full_like(i, 2 ** 31 + 5), i == 0


def structured_traces(torch, device, n_bins):
    """K1's structured cases, as (name, thunk): shapes that put segment
    edges on the kernel's range edges, cross every range, or hold one kind
    of event only."""
    from repro_torch.kernels.lifetime_scan import kernel as k
    cases = [
        ("long_segment", lambda: long_segment(LONG_SEGMENT_EVENTS, torch,
                                              device)),
        ("reads_only", lambda: random_sorted_trace(
            1_000_003, 125_000, 0.0, seed=101, torch=torch, device=device)),
        ("writes_only", lambda: random_sorted_trace(
            1_000_003, 125_000, 1.0, seed=102, torch=torch, device=device)),
    ]
    n = 4_000_000
    slice_, _ = k.launch_grid(n, n_bins, device)
    for what, length in (("slice", slice_), ("range", 8 * slice_)):
        for shift in (0, 1):
            cases.append((f"{what}_long_segments_shift{shift}",
                          lambda length=length, shift=shift: segments_of(
                              n, length, shift, torch, device)))
    # n at a multiple of the range length (every block's range full), and
    # one event either side
    slice_, blocks = k.launch_grid(5_000_000, n_bins, device)
    whole = 8 * slice_ * blocks
    for dn in (-1, 0, 1):
        cases.append((f"n_at_range_multiple{dn:+d}",
                      lambda m=whole + dn: random_sorted_trace(
                          m, m // 8, 0.35, seed=103, torch=torch,
                          device=device)))
    return cases


def phase_kernel_check(torch, device) -> dict:
    from repro_torch.kernels.lifetime_scan import kernel as k
    from repro_torch.kernels.lifetime_scan.ops import (default_edges,
                                                       integer_edges)
    edges = torch.from_numpy(integer_edges(default_edges())).to(device)
    n_bins = edges.shape[0] - 1

    def check(t, a, w, what):
        hist, stats = k.lifetime_scan_sorted(t, a, w, edges)
        torch.cuda.synchronize()
        hist_p, stats_p = k.lifetime_scan_plain(t, a, w, edges)
        err = max(int((hist - hist_p).abs().max()),
                  int((stats - stats_p).abs().max()))
        if err != 0:
            raise AssertionError(
                f"lifetime_scan kernel != plain version at {what}: "
                f"{stats.tolist()} vs {stats_p.tolist()}")
        if int(stats[0] + stats[1]) < 1 or \
                int(stats[4] + stats[5]) != t.shape[0]:
            raise AssertionError(f"kernel_check trace is degenerate: {what}")
        return err

    cases, max_err = 0, 0
    for n in (1, 257, 100_000, 10_000_000):
        for n_addrs in (3, max(4, n // 8)):
            for p_write in (0.05, 0.35, 0.95):
                t, a, w = random_sorted_trace(
                    n, n_addrs, p_write, seed=cases, torch=torch,
                    device=device)
                max_err = max(max_err, check(
                    t, a, w, f"n={n} n_addrs={n_addrs} p_write={p_write}"))
                cases += 1
    structured = []
    for name, make in structured_traces(torch, device, n_bins):
        t, a, w = make()
        err = check(t, a, w, name)
        max_err = max(max_err, err)
        slice_, blocks = k.launch_grid(t.shape[0], n_bins, device)
        structured.append({"case": name, "events": t.shape[0],
                           "slice": slice_, "blocks": blocks,
                           "max_abs_err": err})
        del t, a, w
    # an empty stream returns zeros and launches nothing
    e = torch.zeros(0, dtype=torch.int64, device=device)
    before = k.lifetime_scan_sorted.launches
    hist, stats = k.lifetime_scan_sorted(e, e, e.bool(), edges)
    if hist.any() or stats.any() or \
            k.lifetime_scan_sorted.launches != before:
        raise AssertionError("lifetime_scan of an empty stream")
    emit("kernel_check", kernel="lifetime_scan", cases=cases,
         structured=structured, tolerance="exact (int64)",
         max_abs_err=max_err)
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
    the model layout's strided views, both dtypes, the serving shape and
    the families' training shapes (bf16); in bf16 (the tensor-core kernel)
    two runs of each bit-equal."""
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
    runs += [((*shape, True), "bfloat16")
             for shape in FAMILY_ATTENTION.values()]
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
        before = k.flash_attention_bhsd.launches
        o, lse = k.flash_attention_bhsd(q, kk, v, causal=causal)
        what = f"flash_attention {dt} {(B, H, KV, Sq, Skv, hd, causal)}"
        repeat = dt == "bfloat16"             # the tensor-core kernel
        if repeat:
            o2, lse2 = k.flash_attention_bhsd(q, kk, v, causal=causal)
        torch.cuda.synchronize()
        if repeat and not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            raise AssertionError(f"{what}: two runs differ")
        if k.flash_attention_bhsd.launches != before + 1 + repeat:
            raise AssertionError(f"{what}: the wrapper did not launch")
        o_p, lse_p = k.flash_attention_plain(q, kk, v, causal=causal)
        tol = FA_TOL[dt]
        err = max(within(o, o_p, tol, what + " o"),
                  within(lse, lse_p, tol, what + " lse"))
        max_err[dt] = max(max_err[dt], err)
        cases.append([B, H, KV, Sq, Skv, hd, causal, model, dt, err])
    emit("kernel_check", kernel="flash_attention_fwd", cases=len(cases),
         variants={d: k._kernel_variant(getattr(torch, d)) for d in FA_TOL},
         repeat_runs="bit-equal o, lse (bfloat16)",
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
    fp32 B/C, which runs the FMA kernel), Zamba2-2.7B's (h, p, n),
    Mamba-2-130M's and the smoke config's, and the serving shape; with bf16
    x, B and C (the tensor-core kernels) two runs of each bit-equal."""
    from repro_torch.kernels.ssd_scan import kernel as k
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
        (1, 520, 24, 64, 128, 256, "bfloat16", "bfloat16"),
        (2, 40, 8, 16, 16, 32, "bfloat16", "bfloat16"),
    ]
    cases, max_err = [], {"float32": 0.0, "bfloat16": 0.0}
    for i, (b, l, h, p, n, chunk, dx, dbc) in enumerate(runs):
        x, dt, A, B, C, D = ssd_inputs(torch, device, b, l, h, p, n, dx, dbc,
                                       seed=200 + i)
        what = f"ssd_scan {(b, l, h, p, n, chunk, dx, dbc)}"
        repeat = k._kernel_variant(x.dtype, B.dtype) == "bf16 mma"
        before = k.ssd_scan_chunked.launches
        y = ops.ssd_scan(x, dt, A, B, C, D, chunk=chunk)
        if repeat:
            y2 = ops.ssd_scan(x, dt, A, B, C, D, chunk=chunk)
        torch.cuda.synchronize()
        if k.ssd_scan_chunked.launches != before + 1 + repeat:
            raise AssertionError(f"{what}: the wrapper did not launch")
        if repeat and not torch.equal(y, y2):
            raise AssertionError(f"{what}: two runs differ")
        with plain_kernels():
            y_p = ops.ssd_scan(x, dt, A, B, C, D, chunk=chunk)
        err = within(y, y_p, SSD_TOL[dx], what)
        max_err[dx] = max(max_err[dx], err)
        cases.append([b, l, h, p, n, chunk, dx, dbc, err])
    emit("kernel_check", kernel="ssd_scan", cases=len(cases),
         variants={f"{dx} x, {dbc} B/C": k._kernel_variant(
             getattr(torch, dx), getattr(torch, dbc))
             for dx, dbc in sorted({r[6:] for r in runs})},
         repeat_runs="bit-equal y (bfloat16 x, B and C)",
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
    out = generate(api, {"tokens": tokens}, int(fx["prompt_len"]),
                   int(fx["gen"]))
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
    batch = api.make_batch(
        torch.Generator(device=device).manual_seed(SERVE["token_seed"]),
        ShapeCell("serve", "prefill", total, SERVE["batch"]))

    with first_calls() as seen:                           # warm-up
        generate(api, batch, SERVE["prompt_len"], 2)
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
    out = generate(api, batch, SERVE["prompt_len"], SERVE["gen"])
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
        plain = generate(api, batch, SERVE["prompt_len"], SERVE["gen"])
    bf16 = compare_paths(out, plain, SERVE_REL_TOL["bfloat16"], "bf16")
    api.model.cfg = dataclasses.replace(cfg, attn_impl="ref")
    ref = generate(api, batch, SERVE["prompt_len"], 2)
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
    out32 = generate(api, batch, SERVE["prompt_len"], SERVE["gen"])
    with plain_kernels():
        plain32 = generate(api, batch, SERVE["prompt_len"], SERVE["gen"])
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
        BF16_FLOPS_PER_S, lib_ms, variant=fa_k._kernel_variant(bf16),
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
    # the float32 FMA kernel at the same shape (float32 x, B and C)
    x32, B32, C32 = x.float(), Bm.float(), Cm.float()
    fp32_ms = statistics.median(cuda_ms(
        lambda: ssd_k.ssd_scan_chunked(x32, dt, A, B32, C32, D, chunk=Q),
        runs=10))
    del x32, B32, C32
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
        variant=ssd_k._kernel_variant(bf16, bf16), fp32_ms=fp32_ms,
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
    recompute (remat), each backward kernel once per layer; Whisper's
    encoder and decoder self-attention layers each count (its
    cross-attention runs no kernel)."""
    n = cfg.n_layers + cfg.enc_layers
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
    shapes (GQA, ragged, Sq != Skv, causal and not), every head dim the
    kernels are built for, the model layout's strided views, both dtypes
    (bf16 runs K3 and K4 on the tensor cores), the training shape, the
    families' training shapes (bf16); and two runs of each bit-equal."""
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
        (1, 4, 2, 130, 130, 48, True),
        (1, 2, 1, 70, 150, 96, False),
        (2, 2, 2, 64, 100, 112, True),
    ]
    runs = [(i, shape, dt) for i, shape in enumerate(shapes)
            for dt in ("float32", "bfloat16")]
    runs += [(len(shapes) + i, shape, "bfloat16")
             for i, shape in enumerate(FAMILY_ATTENTION.values())]
    cases, max_err = [], {"float32": 0.0, "bfloat16": 0.0}
    for i, shape, dt in runs:
        model = i % 2 == 1 or shape == train_attention_shape() or \
            i >= len(shapes)
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
         dq_variants={d: bwd_k._kernel_variant(getattr(torch, d))
                      for d in BWD_TOL},
         dkv_variants={d: bwd_k._kernel_variant(getattr(torch, d))
                       for d in BWD_TOL},
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


def shape_fields(shape) -> dict:
    B, H, KV, Sq, Skv, hd, causal = shape
    return {"B": B, "H": H, "KV": KV, "Sq": Sq, "Skv": Skv, "hd": hd,
            "causal": causal, "dtype": "bfloat16"}


def time_attention(torch, device, shape, seed) -> list:
    """K2, K3 and K4 at ``shape`` (B, H, KV, Sq, Skv, hd, causal; bf16, the
    model layout), every call with the shape's own mask: each kernel's and
    its plain version's time, its bound, and ``F.scaled_dot_product_attention``'s
    forward (K2) or backward (one number for K3 + K4 together) at the same
    shape.  Three ``kernel_row`` dicts, launches and errors left None."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention import kernel_bwd as bwd_k
    B, H, KV, Sq, Skv, hd, causal = shape
    q, k, v, o, lse, do = bwd_inputs(torch, device, shape, torch.bfloat16,
                                     True, seed=seed)
    # (q, kv) pairs the mask leaves (causal: top-left aligned)
    per_head = sum(min(i + 1, Skv) for i in range(Sq)) if causal \
        else Sq * Skv
    pairs = B * H * per_head
    qb, kvb = B * H * Sq * hd * 2, B * KV * Skv * hd * 2

    def timed(fn, runs):
        return statistics.median(cuda_ms(fn, runs=runs))
    fwd = kernel_row(
        "flash_attention_fwd", FA_SOURCE, FA_REPLACES, None, None,
        timed(lambda: fa_k.flash_attention_bhsd(q, k, v, causal=causal), 20),
        timed(lambda: fa_k.flash_attention_plain(q, k, v, causal=causal), 5),
        2 * qb + 2 * kvb + 4 * B * H * Sq, 4 * hd * pairs, BF16_FLOPS_PER_S,
        timed(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), 20))
    _, delta = bwd_k.flash_attention_bwd_dq(q, k, v, o, lse, do,
                                            causal=causal)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    ref = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                         enable_gqa=True)
    lib_ms = timed(lambda: torch.autograd.grad(ref, leaves, do,
                                               retain_graph=True), 20)
    # K3 reads q, o, dO, k, v, lse and writes dq, delta; K4 reads q, dO, k,
    # v, lse, delta and writes the per-query-head dk, dv
    bwd_bytes = 4 * qb + 2 * kvb + 2 * 4 * B * H * Sq
    dq = kernel_row(
        "flash_attention_bwd_dq", BWD_SOURCE, DQ_REPLACES, None, None,
        timed(lambda: bwd_k.flash_attention_bwd_dq(q, k, v, o, lse, do,
                                                   causal=causal), 20),
        timed(lambda: bwd_k.bwd_dq_plain(q, k, v, o, lse, do,
                                         causal=causal), 5),
        bwd_bytes, 6 * hd * pairs, BF16_FLOPS_PER_S, lib_ms)
    dkv = kernel_row(
        "flash_attention_bwd_dkv", BWD_SOURCE, DKV_REPLACES, None, None,
        timed(lambda: bwd_k.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                    causal=causal), 20),
        timed(lambda: bwd_k.bwd_dkv_plain(q, k, v, do, lse, delta,
                                          causal=causal), 5),
        bwd_bytes, 8 * hd * pairs, BF16_FLOPS_PER_S, lib_ms)
    del q, k, v, o, lse, do, delta, leaves, ref
    torch.cuda.empty_cache()
    return [fwd, dq, dkv]


def time_training_kernels(torch, device, train, bwd_check, fa_row) -> list:
    """K3 and K4 at the shape the training path launches them with; SDPA's
    backward (GQA) as the one library call computing both.  K2's time at
    that shape goes into its row (``train``) beside its serving numbers.
    K2's, K3's and K4's rows also carry ``fp32_ms``: the float32 FMA
    kernels on float32 inputs at the training shape."""
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention import kernel_bwd as bwd_k
    shape = train_attention_shape()
    causal = shape[-1]
    fwd, dq_row, dkv_row = time_attention(torch, device, shape, seed=500)
    # K2's row keeps its serving-shape numbers; these are the training's
    fa_row["train"] = {key: fwd[key] for key in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    fa_row["train"].update(launches=train["counts"][0],
                           shape=shape_fields(shape))
    # the float32 FMA kernels at the same shape (float32 inputs)
    q32, k32, v32, o32, lse32, do32 = bwd_inputs(
        torch, device, shape, torch.float32, True, seed=501)
    fa_row["fp32_ms"] = statistics.median(cuda_ms(
        lambda: fa_k.flash_attention_bhsd(q32, k32, v32, causal=causal),
        runs=10))
    fa_row["fp32_ms_shape"] = "train"
    _, delta32 = bwd_k.flash_attention_bwd_dq(q32, k32, v32, o32, lse32, do32,
                                              causal=causal)
    dq_row["fp32_ms"] = statistics.median(cuda_ms(
        lambda: bwd_k.flash_attention_bwd_dq(q32, k32, v32, o32, lse32,
                                             do32, causal=causal), runs=10))
    dkv_row["fp32_ms"] = statistics.median(cuda_ms(
        lambda: bwd_k.flash_attention_bwd_dkv(q32, k32, v32, do32, lse32,
                                              delta32, causal=causal),
        runs=10))
    del q32, k32, v32, o32, lse32, do32, delta32
    for i, row in ((1, dq_row), (2, dkv_row)):
        row.update(launches=train["counts"][i],
                   max_abs_err=bwd_check["max_abs_err"],
                   variant=bwd_k._kernel_variant(torch.bfloat16),
                   shape=shape_fields(shape),
                   library_call="backward of F.scaled_dot_product_attention("
                                f"is_causal={causal}, enable_gqa=True): one "
                                "number for K3 + K4 together")
    return [dq_row, dkv_row]


@contextlib.contextmanager
def no_plain_calls(what):
    """Count every call of the attention kernels' plain versions for the
    duration; raise if there was one (on the card the path must run the
    kernels, never their plain versions)."""
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention import kernel_bwd as bwd_k
    targets = [(fa_k, "flash_attention_plain"),
               (bwd_k, "flash_attention_bwd_plain"),
               (bwd_k, "bwd_dq_plain"), (bwd_k, "bwd_dkv_plain")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]
    calls = {name: 0 for _, name in targets}

    def counting(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call
    for mod, name, fn in saved:
        setattr(mod, name, counting(name, fn))
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    if any(calls.values()):
        raise AssertionError(f"{what}: plain-version calls on the card "
                             f"{calls}")


def family_serving_counts(cfg) -> int:
    """K2 launches a prefill makes: Whisper's encoder and its cache-less
    decoder prefill run the kernel in every layer; the transformer's
    prefill threads its cache and takes the blockwise path (no kernel), as
    the reference's does; decode steps run none."""
    return cfg.enc_layers + cfg.n_layers if cfg.family == "audio" else 0


def golden_run(torch, np, device, cfg, fx, want, tol, what) -> dict:
    """``cfg`` on the card with a golden fixture's parameters and batches
    (``fx``): ``generate`` over its serving batch and one training step on
    its training batch, held to ``want``'s prefill logits (abs), greedy
    tokens (equal) and loss, grad norm and lr (relative) within ``tol``.
    Returns the errors and each half's kernel launches."""
    from repro_torch.convert import load_reference_params, tree_from_flat
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.models.api import build

    def part(prefix):
        return {k[len(prefix):]: torch.from_numpy(v).to(device)
                for k, v in fx.items() if k.startswith(prefix)}
    api = build(cfg, device=device)
    load_reference_params(api.model, tree_from_flat(fx, "param:", api.model))
    reset_training_counts()
    out = generate(api, part("serve:"), int(fx["prompt_len"]),
                   int(fx["gen"]))
    serve_counts = training_counts()
    logits = out.prefill_logits.cpu().numpy()
    err = float(np.abs(logits - want["prefill_logits"]).max())
    if not np.isfinite(logits).all() or err > tol["logits"]:
        raise AssertionError(f"{what}: prefill logits differ from the JAX "
                             f"reference by {err}")
    tokens = out.tokens.cpu().numpy()
    if not np.array_equal(tokens, want["greedy_tokens"]):
        raise AssertionError(f"{what}: greedy tokens {tokens.tolist()} != "
                             f"{want['greedy_tokens'].tolist()}")
    opt = make_optimizer(cfg, total_steps=1)
    params = dict(api.model.named_parameters())
    reset_training_counts()
    _, _, m = make_train_step(api, opt)(params, opt.init(params),
                                        part("train:"))
    step_counts = training_counts()
    rel = {}
    for k in ("loss", "grad_norm", "lr"):
        rel[k] = abs(float(m[k]) - float(want[k])) / abs(float(want[k]))
        if not math.isfinite(float(m[k])) or rel[k] > tol[k]:
            raise AssertionError(f"{what}: {k} {float(m[k])} != "
                                 f"{float(want[k])}")
    return {"max_abs_logit_err": err, "step_rel_err": rel,
            "serve_launches": serve_counts, "step_launches": step_counts}


def phase_family_golden(torch, np, device) -> None:
    """The MoE, VLM and audio smoke configs on the card, in float32, against
    the JAX reference's golden fixtures (``golden_run``), with the kernels
    where the fixture's ``attn_impl`` is "flash" (InternVL2's smoke head
    dim, 14, is not one the kernels take: "ref")."""
    from repro_torch.configs.base import get_config

    runs = {}
    for arch in FAMILY_ARCHS:
        fx = dict(np.load(ROOT / "tests" / "fixtures" / "torch" /
                          f"golden_{arch}_smoke.npz"))
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  attn_impl=str(fx["attn_impl"]),
                                  param_dtype="float32")
        flash = cfg.attn_impl == "flash"
        with no_plain_calls(f"family_golden {arch}"):
            run = golden_run(torch, np, device, cfg, fx, fx,
                             FAMILY_GOLDEN_TOL, f"family_golden {arch}")
        want = (family_serving_counts(cfg) if flash else 0, 0, 0)
        if run["serve_launches"] != want:
            raise AssertionError(f"family_golden {arch}: serving launches "
                                 f"{run['serve_launches']}, expected {want}")
        want = expected_train_counts(cfg) if flash else (0, 0, 0)
        if run["step_launches"] != tuple(want):
            raise AssertionError(f"family_golden {arch}: step launches "
                                 f"{run['step_launches']}, expected {want}")
        runs[arch] = {"attn_impl": cfg.attn_impl, "tokens_equal": True,
                      **run}
    emit("family_golden", config="smoke, float32", tolerance=FAMILY_GOLDEN_TOL,
         runs=runs)


def serve_family(torch, device, arch) -> dict:
    """One family served as published (bf16, kernels on): a warm-up, then
    the main run, each launch counted; deepseek-moe-16b's prefill once more,
    which must give the same bits."""
    from repro_torch.configs.base import ShapeCell, get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models.api import build

    cfg = dataclasses.replace(get_config(arch), attn_impl="flash")
    prompt_len, gen = FAMILY_SERVE[arch]
    t0 = time.perf_counter()
    api = build(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(FAMILY_SEEDS["param"]))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in api.model.parameters())
    batch = api.make_batch(
        torch.Generator(device=device).manual_seed(FAMILY_SEEDS["token"]),
        ShapeCell("serve", "prefill", prompt_len + gen, FAMILY_BATCH))
    generate(api, batch, prompt_len, 2)                   # warm-up

    torch.cuda.reset_peak_memory_stats()
    reset_training_counts()                  # main path starts here
    with no_plain_calls(f"families serve {arch}"):
        out = generate(api, batch, prompt_len, gen)
    counts = training_counts()               # main path ends here
    peak = torch.cuda.max_memory_allocated()
    want = (family_serving_counts(cfg), 0, 0)
    if counts != want:
        raise AssertionError(f"families serve {arch}: (fwd, dq, dkv) "
                             f"launches {counts}, expected {want}")
    logits = out.prefill_logits
    if tuple(logits.shape) != (FAMILY_BATCH, cfg.vocab) or \
            not bool(logits.float().isfinite().all()):
        raise AssertionError(f"families serve {arch}: prefill logits are "
                             f"not finite [batch, vocab]")
    row = {"n_layers": cfg.n_layers, "enc_layers": cfg.enc_layers,
           "d_model": cfg.d_model, "params": n_params,
           "param_dtype": cfg.param_dtype, "batch": FAMILY_BATCH,
           "prompt_len": prompt_len, "gen": gen, "init_s": init_s,
           "prefill_s": out.prefill_s, "decode_s": out.decode_s,
           "decode_tokens_per_s": FAMILY_BATCH * (gen - 1) / out.decode_s,
           "max_memory_allocated": peak, "k2_launches": counts[0],
           "tokens_batch0": out.tokens[0].tolist()}
    if cfg.moe_experts:
        again, _ = api.prefill(batch)
        if not torch.equal(again, logits):
            raise AssertionError(f"families serve {arch}: two prefills of "
                                 f"the batch differ")
        row["repeat_prefill_bit_equal"] = True
    del api, batch, out
    torch.cuda.empty_cache()
    return row


def train_family(torch, device, arch) -> dict:
    """One family trained (bf16 parameters, fp32 AdamW, remat, kernels on)
    for FAMILY_STEPS steps at batch FAMILY_BATCH; the launches of each step
    against the config's count."""
    from repro_torch.configs.base import ShapeCell, get_config
    from repro_torch.data import SyntheticLMDataset, to_device
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.models.api import build

    tr = FAMILY_TRAIN[arch]
    cfg = dataclasses.replace(get_config(arch), attn_impl="flash",
                              n_layers=tr.get("n_layers",
                                              get_config(arch).n_layers))
    shape = ShapeCell("train", "train", tr["seq"], FAMILY_BATCH)
    api = build(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(FAMILY_SEEDS["param"]))
    opt = make_optimizer(cfg, total_steps=FAMILY_STEPS)
    step_fn = make_train_step(api, opt)
    params = dict(api.model.named_parameters())
    state = opt.init(params)
    n_params = sum(p.numel() for p in params.values())
    ds = SyntheticLMDataset(cfg, shape, seed=FAMILY_SEEDS["data"])
    batches = [to_device(ds.get_batch(i), device)
               for i in range(FAMILY_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps, per_step = [], []
    reset_training_counts()                  # main path starts here
    with no_plain_calls(f"families train {arch}"):
        for batch in batches:
            c0 = training_counts()
            torch.cuda.synchronize()
            ts = time.perf_counter()
            params, state, m = step_fn(params, state, batch)
            torch.cuda.synchronize()
            steps.append({"step_s": time.perf_counter() - ts,
                          "loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"])})
            per_step.append([a - b for a, b in zip(training_counts(), c0)])
    counts = training_counts()               # main path ends here
    peak = torch.cuda.max_memory_allocated()
    want = list(expected_train_counts(cfg))
    if any(c != want for c in per_step):
        raise AssertionError(f"families train {arch}: (fwd, dq, dkv) "
                             f"launches per step {per_step}, expected {want}")
    if not all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
               for s in steps):
        raise AssertionError(f"families train {arch}: non-finite {steps}")
    del api, params, state, step_fn, batches
    torch.cuda.empty_cache()
    steady = statistics.median([s["step_s"] for s in steps[1:]])
    # every position a step runs: text tokens, vision embeddings, frames
    positions = FAMILY_BATCH * (tr["seq"] + cfg.vision_tokens + cfg.enc_seq)
    return {"n_layers": cfg.n_layers, "enc_layers": cfg.enc_layers,
            "params": n_params, "batch": FAMILY_BATCH, "seq": tr["seq"],
            "vision_tokens": cfg.vision_tokens, "frames": cfg.enc_seq,
            "first_step_s": steps[0]["step_s"],
            "median_step_s_2_to_3": steady,
            "tokens_per_s": FAMILY_BATCH * tr["seq"] / steady,
            "positions_per_s": positions / steady, "steps": steps,
            "max_memory_allocated": peak, "launches": counts,
            "launches_per_step": per_step, "expected_per_step": want}


def family_f32_step(torch, device, arch) -> dict:
    """One float32 forward and backward of the family at full width and
    FAMILY_F32's depth and batch, kernel path against plain path (gated by
    TRAIN_REL_TOL)."""
    from repro_torch.configs.base import ShapeCell, get_config
    from repro_torch.data import SyntheticLMDataset, to_device
    from repro_torch.models.api import build

    base = get_config(arch)
    cut = {"n_layers": FAMILY_F32["n_layers"]}
    if base.enc_layers:
        cut["enc_layers"] = FAMILY_F32["n_layers"]
    cfg = dataclasses.replace(base, attn_impl="flash", param_dtype="float32",
                              **cut)
    api = build(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(FAMILY_SEEDS["param"]))
    ds = SyntheticLMDataset(cfg, ShapeCell("f32", "train",
                                           FAMILY_TRAIN[arch]["seq"],
                                           FAMILY_F32["batch"]),
                            seed=FAMILY_SEEDS["data"])
    batch = to_device(ds.get_batch(0), device)
    reset_training_counts()
    kern = loss_and_grads(torch, api, batch)
    counts = training_counts()
    with plain_kernels():
        plain = loss_and_grads(torch, api, batch)
    f32 = grad_distance(torch, kern, plain)
    f32.update(launches=counts, **cut)
    del api, kern, plain, batch
    torch.cuda.empty_cache()
    n = cfg.n_layers + cfg.enc_layers
    if counts != (2 * n, n, n):
        raise AssertionError(f"families f32 {arch}: launches {counts}")
    if f32["loss_rel_err"] > TRAIN_REL_TOL["loss"] or \
            f32["grad_max_rel_2norm_err"] > TRAIN_REL_TOL["grad"]:
        raise AssertionError(f"families f32 {arch}: kernel path differs "
                             f"from the plain path: {f32}")
    return f32


def phase_families(torch, device) -> dict:
    """The MoE, VLM and audio families on the card: each served as
    published, then trained (deepseek-moe-16b at full width and 4 layers),
    then one float32 step at reduced depth, kernel path against plain path.
    The served model is freed before its training starts.  Returns each
    family's K2/K3/K4 launches."""
    serve, train, f32 = {}, {}, {}
    for arch in FAMILY_ARCHS:
        serve[arch] = serve_family(torch, device, arch)
        train[arch] = train_family(torch, device, arch)
        f32[arch] = family_f32_step(torch, device, arch)
    emit("families", param_seed=FAMILY_SEEDS["param"],
         attn_impl="flash", serve=serve, train=train,
         kernel_vs_plain_float32=f32, tolerance=TRAIN_REL_TOL)
    return {arch: {"serve_k2_launches": serve[arch]["k2_launches"],
                   "train_launches": train[arch]["launches"]}
            for arch in FAMILY_ARCHS}


def time_family_kernels(torch, device, rows, families) -> None:
    """K2, K3 and K4 at the families' attention shapes (``time_attention``,
    each with its own mask), added to the K2, K3 and K4 rows with the
    families' launches."""
    by_name = {r["name"]: r for r in rows}
    out = {"flash_attention_fwd": [], "flash_attention_bwd_dq": [],
           "flash_attention_bwd_dkv": []}
    for i, (what, shape) in enumerate(FAMILY_ATTENTION.items()):
        for r in time_attention(torch, device, shape, seed=600 + i):
            out[r["name"]].append({"path": what, "shape": shape_fields(shape),
                                   **{key: r[key] for key in (
                                       "ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms", "bytes",
                                       "flops")}})
    for i, (name, entries) in enumerate(out.items()):    # fwd, dq, dkv
        by_name[name]["family_shapes"] = entries
        by_name[name]["family_launches"] = {
            arch: {"serve": f["serve_k2_launches"] if i == 0 else 0,
                   "train": f["train_launches"][i]}
            for arch, f in families.items()}
    by_name["flash_attention_bwd_dq"]["family_library_call"] = (
        "backward of F.scaled_dot_product_attention(is_causal=<the shape's>, "
        "enable_gqa=True): one number for K3 + K4 together")


def reset_kernel_counts():
    from repro_torch.kernels.ssd_scan import kernel as ssd_k
    reset_training_counts()
    ssd_k.ssd_scan_chunked.launches = 0


def kernel_counts() -> dict:
    """Launches of every serving and training kernel wrapper."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_k
    fwd, dq, dkv = training_counts()
    return {"flash_attention_fwd": fwd, "flash_attention_bwd_dq": dq,
            "flash_attention_bwd_dkv": dkv,
            "ssd_scan": ssd_k.ssd_scan_chunked.launches}


def tuned_model(torch, device, cfg):
    from repro_torch.models.api import build
    return build(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(TUNED["param_seed"]))


def tuned_decode_loop(torch, api, batch) -> dict:
    """Prefill, then ``gen - 1`` greedy decode steps: each step's logits,
    the last cache, the loop's seconds, its peak memory above the memory
    at its start, and whether every step returned the tensors it was
    given (the in-place cache)."""
    P, G = TUNED["prompt_len"], TUNED["gen"]
    logits, cache = api.prefill(batch)
    tok = torch.argmax(logits, dim=-1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    steps, returned_given = [], True
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(G - 1):
            given = cache
            logits, cache = api.decode(cache, tok, P + i)
            returned_given &= all(
                a.data_ptr() == b.data_ptr()
                for name in given for a, b in zip(given[name], cache[name]))
            steps.append(logits)
            tok = torch.argmax(logits, dim=-1)
    torch.cuda.synchronize()
    return {"logits": steps, "cache": cache,
            "loop_s": time.perf_counter() - t0,
            "peak_above_start": torch.cuda.max_memory_allocated() - base,
            "returned_given_cache": bool(returned_given)}


def decode_step_split(torch, device="cuda") -> dict:
    """Device time of one decode step of TUNED's served model, by CUDA
    op, decode_inplace off and on: a ``torch.profiler`` trace of
    ``profile_steps`` steps after two warm-up steps, per step.  Run by a
    fresh interpreter (``PROFILE_DECODE``; see ``profile_fresh``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import ShapeCell, get_tuned_config
    device = torch.device(device)
    cfg = get_tuned_config(TUNED["arch"])
    api = tuned_model(torch, device, cfg)
    P, n = TUNED["prompt_len"], TUNED["profile_steps"]
    batch = api.make_batch(
        torch.Generator(device=device).manual_seed(TUNED["token_seed"]),
        ShapeCell("serve", "prefill", P + TUNED["gen"], TUNED["batch"]))
    out = {}
    for inplace in (False, True):
        api.model.cfg = dataclasses.replace(cfg, decode_inplace=inplace)
        with torch.no_grad():
            logits, cache = api.prefill(batch)
            tok = torch.argmax(logits, dim=-1)
            for i in range(2):
                logits, cache = api.decode(cache, tok, P + i)
            torch.cuda.synchronize(device)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for i in range(2, 2 + n):
                    logits, cache = api.decode(cache, tok, P + i)
                torch.cuda.synchronize(device)
                wall = time.perf_counter() - t0
        ops = {}
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            k, us = ops.get(ev.name, (0, 0.0))
            ops[ev.name] = (k + 1, us + ev.time_range.elapsed_us())
        # None where the trace holds no device activity (not measured)
        device_us = sum(us for _, us in ops.values()) / n if ops else None
        wall_us = wall * 1e6 / n
        top = sorted(ops.items(), key=lambda kv: -kv[1][1])
        out["inplace" if inplace else "copy"] = {
            "wall_us_per_step": wall_us, "device_us_per_step": device_us,
            "device_idle_share": None if device_us is None
            else 1.0 - device_us / wall_us,
            "device_ops_per_step": sum(k for k, _ in ops.values()) / n,
            "top_ops": [{"name": name[:96], "launches_per_step": k / n,
                         "device_us_per_step": us / n}
                        for name, (k, us) in top[:12]]}
        del logits, cache
    return out


# run by a fresh interpreter: the decode step split of the tuned phase
PROFILE_DECODE = """
import json
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
print(json.dumps(cs.decode_step_split(torch)))
"""


def tuned_serve(torch, device) -> dict:
    """TinyLlama-1.1B's tuned config served, decode_inplace off and on:
    ``generate`` (prefill s, decode tokens/s, tokens), then the decode loop
    again recording each step's logits, its peak memory and the cache it
    returns.  Gates: equal tokens, bit-equal logits at every step and the
    same last cache both ways; the in-place steps return the cache they
    were given, the copying steps new tensors."""
    from repro_torch.configs.base import ShapeCell, get_tuned_config
    from repro_torch.launch.serve import generate

    cfg = get_tuned_config(TUNED["arch"])
    P, G, B = TUNED["prompt_len"], TUNED["gen"], TUNED["batch"]
    t0 = time.perf_counter()
    api = tuned_model(torch, device, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = api.make_batch(
        torch.Generator(device=device).manual_seed(TUNED["token_seed"]),
        ShapeCell("serve", "prefill", P + G, B))
    generate(api, batch, P, 2)                            # warm-up
    runs, loops, outs = {}, {}, {}
    for inplace in (False, True):
        name = "inplace" if inplace else "copy"
        api.model.cfg = dataclasses.replace(cfg, decode_inplace=inplace)
        outs[name] = generate(api, batch, P, G)
        loops[name] = tuned_decode_loop(torch, api, batch)
        runs[name] = {
            "prefill_s": outs[name].prefill_s,
            "decode_s": outs[name].decode_s,
            "decode_tokens_per_s": B * (G - 1) / outs[name].decode_s,
            "decode_loop_s": loops[name]["loop_s"],
            "decode_loop_peak_above_start": loops[name]["peak_above_start"],
            "returned_given_cache": loops[name]["returned_given_cache"]}
    api.model.cfg = cfg
    logits = outs["copy"].prefill_logits
    if tuple(logits.shape) != (B, cfg.vocab) or \
            not bool(logits.float().isfinite().all()):
        raise AssertionError("tuned serve: prefill logits are not finite "
                             "[batch, vocab]")
    if not torch.equal(outs["copy"].tokens, outs["inplace"].tokens):
        raise AssertionError("tuned serve: decode_inplace changes the "
                             "greedy tokens")
    copy, inpl = loops["copy"], loops["inplace"]
    if not all(torch.equal(a, b) for a, b in zip(copy["logits"],
                                                 inpl["logits"])):
        raise AssertionError("tuned serve: decode_inplace changes the "
                             "decode logits")
    if not all(torch.equal(a, b) for name in copy["cache"]
               for a, b in zip(copy["cache"][name], inpl["cache"][name])):
        raise AssertionError("tuned serve: decode_inplace ends with another "
                             "cache")
    if not inpl["returned_given_cache"] or copy["returned_given_cache"]:
        raise AssertionError(f"tuned serve: returned caches {runs}")
    del api, batch, outs, loops, copy, inpl
    torch.cuda.empty_cache()
    return {"n_layers": cfg.n_layers, "attn_impl": cfg.attn_impl,
            "batch": B, "prompt_len": P, "gen": G, "init_s": init_s,
            "logits_bit_equal": True, "tokens_equal": True, "runs": runs}


def tuned_train_run(torch, device, cfg, batches) -> dict:
    """TUNED's steps of ``cfg`` from freshly drawn weights: step seconds,
    losses and the peak memory above the model and optimizer state."""
    from repro_torch.launch.steps import make_optimizer, make_train_step
    api = tuned_model(torch, device, cfg)
    opt = make_optimizer(cfg, total_steps=TUNED["steps"])
    step_fn = make_train_step(api, opt)
    params = dict(api.model.named_parameters())
    state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    steps = []
    for batch in batches:
        torch.cuda.synchronize()
        ts = time.perf_counter()
        params, state, m = step_fn(params, state, batch)
        torch.cuda.synchronize()
        steps.append({"step_s": time.perf_counter() - ts,
                      "loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"])})
    peak = torch.cuda.max_memory_allocated()
    # what the forward keeps for the backward: memory held by the graph of
    # one loss, measured between the forward and its release
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    loss = api.loss(batches[0])
    torch.cuda.synchronize()
    kept = torch.cuda.memory_allocated() - before
    del loss, api, opt, step_fn, params, state
    torch.cuda.empty_cache()
    if not all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
               for s in steps):
        raise AssertionError(f"tuned train: non-finite {steps}")
    steady = statistics.median(s["step_s"] for s in steps[1:])
    return {"save_proj_remat": cfg.save_proj_remat, "steps": steps,
            "first_step_s": steps[0]["step_s"],
            "median_step_s_2_to_5": steady,
            "tokens_per_s": TUNED["batch"] * TUNED["seq"] / steady,
            "max_memory_allocated": peak, "peak_above_state": peak - base,
            "kept_by_forward": kept}


def tuned_train(torch, device) -> dict:
    """TinyLlama-1.1B's tuned config trained TUNED["steps"] steps at
    batch x seq with save_proj_remat and again with plain remat (same
    weights and batches); then the float32 gates at f32_layers layers:
    save_proj_remat against plain remat (TUNED_PROJ_REL_TOL), the tuned
    step against the untuned attn_impl="ref" step without tp_bf16_reduce
    (TRAIN_REL_TOL) and with it (TUNED_BF16_REDUCE_REL_TOL)."""
    from repro_torch.configs.base import (ShapeCell, get_config,
                                          get_tuned_config)
    from repro_torch.data import SyntheticLMDataset, to_device

    cfg = get_tuned_config(TUNED["arch"])
    ds = SyntheticLMDataset(cfg, ShapeCell("train", "train", TUNED["seq"],
                                           TUNED["batch"]),
                            seed=TUNED["data_seed"])
    batches = [to_device(ds.get_batch(i), device)
               for i in range(TUNED["steps"])]
    proj = tuned_train_run(torch, device, cfg, batches)
    plain = tuned_train_run(torch, device, dataclasses.replace(
        cfg, save_proj_remat=False), batches)
    del batches
    # two projections [batch, seq, d_model] kept per layer, in bf16
    predicted = cfg.n_layers * 2 * TUNED["batch"] * TUNED["seq"] * \
        cfg.d_model * 2
    extra = proj["kept_by_forward"] - plain["kept_by_forward"]
    if abs(extra - predicted) > TUNED_KEPT_REL_TOL * predicted:
        raise AssertionError(f"tuned train: save_proj_remat's forward keeps "
                             f"{extra} B more than plain remat's, expected "
                             f"{predicted}")

    cut = {"n_layers": TUNED["f32_layers"], "param_dtype": "float32"}
    cfg32 = dataclasses.replace(cfg, **cut)
    ds = SyntheticLMDataset(cfg32, ShapeCell("f32", "train", TUNED["seq"],
                                             TUNED["f32_batch"]),
                            seed=TUNED["data_seed"])
    batch = to_device(ds.get_batch(0), device)
    api = tuned_model(torch, device, cfg32)
    tuned = loss_and_grads(torch, api, batch)
    api.model.cfg = dataclasses.replace(cfg32, save_proj_remat=False)
    vs_plain_remat = grad_distance(torch, tuned, loss_and_grads(
        torch, api, batch))
    api.model.cfg = dataclasses.replace(cfg32, tp_bf16_reduce=False)
    no_reduce = loss_and_grads(torch, api, batch)
    api.model.cfg = dataclasses.replace(get_config(TUNED["arch"]), **cut,
                                        attn_impl="ref")
    untuned = loss_and_grads(torch, api, batch)
    vs_ref = grad_distance(torch, no_reduce, untuned)
    vs_ref_bf16_reduce = grad_distance(torch, tuned, untuned)
    del api, batch, tuned, no_reduce, untuned
    torch.cuda.empty_cache()
    for what, d, tol in (
            ("save_proj_remat vs plain remat", vs_plain_remat,
             {"loss": TUNED_PROJ_REL_TOL, "grad": TUNED_PROJ_REL_TOL}),
            ("tuned without tp_bf16_reduce vs untuned ref", vs_ref,
             TRAIN_REL_TOL),
            ("tuned vs untuned ref", vs_ref_bf16_reduce,
             TUNED_BF16_REDUCE_REL_TOL)):
        if d["loss_rel_err"] > tol["loss"] or \
                d["grad_max_rel_2norm_err"] > tol["grad"]:
            raise AssertionError(f"tuned train (float32): {what}: {d}, "
                                 f"tolerance {tol}")
    return {"n_layers": cfg.n_layers, "batch": TUNED["batch"],
            "seq": TUNED["seq"], "save_proj_remat": proj,
            "plain_remat": plain,
            "peak_difference": proj["max_memory_allocated"]
            - plain["max_memory_allocated"],
            "peak_difference_predicted": predicted,
            "kept_by_forward_difference": extra,
            "bf16_losses_equal": [s["loss"] for s in proj["steps"]]
            == [s["loss"] for s in plain["steps"]],
            "float32": {**cut, "batch": TUNED["f32_batch"],
                        "save_proj_vs_plain_remat": vs_plain_remat,
                        "no_bf16_reduce_vs_untuned_ref": vs_ref,
                        "tuned_vs_untuned_ref": vs_ref_bf16_reduce}}


def tuned_golden(torch, np, device) -> dict:
    """The ten arch configs' tuned smoke configs (float32) on the card
    against the JAX reference's golden fixtures (``golden_run``), as
    published and without tp_bf16_reduce (``TUNED_GOLDEN_TOL``)."""
    from repro_torch.configs.base import ARCH_IDS, get_tuned_config

    runs = {}
    for arch in ARCH_IDS:
        fx = dict(np.load(ROOT / "tests" / "fixtures" / "torch" /
                          f"golden_tuned_{arch}.npz"))
        tuned = dataclasses.replace(get_tuned_config(arch, smoke=True),
                                    param_dtype="float32")
        variants = {"tuned": (tuned, fx)}
        if tuned.tp_bf16_reduce:
            variants["no_bf16_reduce"] = (
                dataclasses.replace(tuned, tp_bf16_reduce=False),
                {k.split(":", 1)[1]: v for k, v in fx.items()
                 if k.startswith("no_bf16_reduce:")})
        for variant, (cfg, want) in variants.items():
            what = f"tuned_golden {arch} {variant}"
            run = golden_run(torch, np, device, cfg, fx, want,
                             TUNED_GOLDEN_TOL[variant], what)
            if any(run["serve_launches"] + run["step_launches"]):
                raise AssertionError(f"{what}: kernel launches {run}")
            runs[f"{arch} {variant}"] = {
                k: run[k] for k in ("max_abs_logit_err", "step_rel_err")}
    return runs


def phase_tuned(torch, np, device, smi) -> None:
    """get_tuned_config on the card: TinyLlama-1.1B served and trained as
    published (``tuned_serve``, ``tuned_train``), the decode step's device
    split from a fresh interpreter, and the ten smoke configs against the
    JAX reference (``tuned_golden``), with no kernel launch and no
    plain-version call anywhere in it."""
    t0 = time.perf_counter()
    reset_kernel_counts()
    with no_plain_calls("tuned"):
        serve = tuned_serve(torch, device)
        train = tuned_train(torch, device)
        counts = kernel_counts()
        # each golden run resets and checks the attention kernels' counts
        golden = tuned_golden(torch, np, device)
    counts["ssd_scan"] = kernel_counts()["ssd_scan"]
    if any(counts.values()):
        raise AssertionError(f"tuned: kernel launches {counts}; the tuned "
                             f"path runs none")
    split = profile_fresh(torch, PROFILE_DECODE, ())
    emit("tuned", nvidia_smi=smi, arch=TUNED["arch"],
         config="get_tuned_config",
         param_dtype="bfloat16", param_seed=TUNED["param_seed"],
         serve=serve, decode_step_split=split, train=train,
         golden_tuned=golden, golden_tolerance=TUNED_GOLDEN_TOL,
         kernel_launches=counts, phase_s=time.perf_counter() - t0)


# the mesh phase: the launchers' --mesh host beside --mesh none
MESH = {"train_arch": "tinyllama_1_1b", "batch": 4, "seq": 2048,
        "steps": 3, "serve_arch": "zamba2_2_7b", "serve_batch": 4,
        "prompt_len": 1008, "gen": 16}
# --mesh host against --mesh none, bf16: each step's loss, relative
MESH_LOSS_REL_TOL = 2e-3
# the dry-run phase: (arch, shape, multi-pod) cells of the production grid
DRYRUN_CELLS = (("tinyllama_1_1b", "train_4k", False),
                ("zamba2_2_7b", "long_500k", False),
                ("deepseek_moe_16b", "train_4k", True))
GOLDEN_DRYRUN = ROOT / "tests" / "fixtures" / "torch" / "golden_dryrun.json"


@contextlib.contextmanager
def no_ssd_plain_calls(what):
    """Count calls of K5's plain version for the duration; raise if there
    was one."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_k
    real = ssd_k.ssd_scan_plain
    calls = {"ssd_scan_plain": 0}

    def call(*args, **kwargs):
        calls["ssd_scan_plain"] += 1
        return real(*args, **kwargs)
    ssd_k.ssd_scan_plain = call
    try:
        yield calls
    finally:
        ssd_k.ssd_scan_plain = real
    if calls["ssd_scan_plain"]:
        raise AssertionError(f"{what}: plain-version calls on the card "
                             f"{calls}")


def mesh_launch(torch, device, what, run):
    """``run()`` with every kernel count at 0 before it, no plain-version
    call allowed and the peak memory reset; (its result, launches, plain
    calls, peak bytes)."""
    import torch.distributed as dist
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    reset_kernel_counts()
    with no_plain_calls(what) as fa_calls, no_ssd_plain_calls(what) as ssd:
        out = run()
    torch.cuda.synchronize(device)
    if dist.is_initialized():
        raise AssertionError(f"{what}: a process group is left initialized")
    return (out, kernel_counts(), sum(fa_calls.values()) + sum(ssd.values()),
            torch.cuda.max_memory_allocated(device))


def mesh_train(torch, device, mesh) -> dict:
    """Three steps of ``launch.train.main`` at batch 4 x 2048 with the
    kernels, ``--mesh`` ``mesh``; each step timed around the step function
    (the loss is read each step, so the step has ended).  The supervisor's
    closing checkpoint (15 GB of parameters and AdamW state, ≈ 30 s of
    disk writes) is counted and not written: the phase measures steps."""
    import tempfile
    import repro_torch.launch.train as train_mod
    real, real_ckpt = train_mod.make_train_step, train_mod.CheckpointManager
    times, saves = [], []

    class CountedCheckpoints(real_ckpt):
        def save(self, step, tree):
            saves.append(step)
            return self._step_dir(step)

    def timed_step(*args, **kwargs):
        step = real(*args, **kwargs)

        def run(*a):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out = step(*a)
            torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t0)
            return out
        return run
    ckpt = tempfile.mkdtemp(prefix="mesh_ckpt_")
    argv = ["--arch", MESH["train_arch"], "--steps", str(MESH["steps"]),
            "--batch", str(MESH["batch"]), "--seq", str(MESH["seq"]),
            "--save-every", "1000", "--ckpt-dir", ckpt, "--mesh", mesh]
    train_mod.make_train_step = timed_step
    train_mod.CheckpointManager = CountedCheckpoints
    try:
        log, launches, plain, peak = mesh_launch(
            torch, device, f"mesh train --mesh {mesh}",
            lambda: train_mod.main(argv, device=device, attn_impl="flash"))
    finally:
        train_mod.make_train_step = real
        train_mod.CheckpointManager = real_ckpt
        import shutil
        shutil.rmtree(ckpt, ignore_errors=True)
    steady = statistics.median(times[1:])
    return {"losses": [m["loss"] for m in log], "step_s": times,
            "tokens_per_s": MESH["batch"] * MESH["seq"] / steady,
            "peak_bytes": peak, "launches": launches, "plain_calls": plain,
            "checkpoint_saves_not_written": saves}


def mesh_serve(torch, device, mesh) -> dict:
    """``launch.serve.main`` with the kernels, ``--mesh`` ``mesh``; the
    ``Generation`` is read from the serving loop it calls."""
    import repro_torch.launch.serve as serve_mod
    real = serve_mod.generate
    got = {}

    def capture(*args, **kwargs):
        got["g"] = real(*args, **kwargs)
        return got["g"]
    argv = ["--arch", MESH["serve_arch"], "--batch",
            str(MESH["serve_batch"]), "--prompt-len", str(MESH["prompt_len"]),
            "--gen", str(MESH["gen"]), "--mesh", mesh]
    serve_mod.generate = capture
    try:
        tokens, launches, plain, peak = mesh_launch(
            torch, device, f"mesh serve --mesh {mesh}",
            lambda: serve_mod.main(argv, device=device, attn_impl="flash"))
    finally:
        serve_mod.generate = real
    g = got["g"]
    return {"tokens": tokens, "prefill_s": g.prefill_s,
            "decode_tokens_per_s": MESH["serve_batch"] * (MESH["gen"] - 1)
            / g.decode_s, "peak_bytes": peak, "launches": launches,
            "plain_calls": plain}


def phase_mesh(torch, np, device, smi) -> None:
    """The launchers under ``--mesh host`` (a (1, 1) mesh over a world of
    one) beside ``--mesh none``, in the same call: equal K2-K5 launch
    counts, no plain call, losses within ``MESH_LOSS_REL_TOL``, equal
    tokens."""
    train = {m: mesh_train(torch, device, m) for m in ("none", "host")}
    serve = {m: mesh_serve(torch, device, m) for m in ("none", "host")}
    for what, runs in (("train", train), ("serve", serve)):
        if runs["host"]["launches"] != runs["none"]["launches"]:
            raise AssertionError(f"mesh {what}: launches "
                                 f"{runs['host']['launches']} under the mesh "
                                 f"!= {runs['none']['launches']} without")
    for what, runs, names in (
            ("train", train, ("flash_attention_fwd", "flash_attention_bwd_dq",
                              "flash_attention_bwd_dkv")),
            ("serve", serve, ("flash_attention_fwd", "ssd_scan"))):
        if not all(runs["none"]["launches"][k] for k in names):
            raise AssertionError(f"mesh {what}: a kernel never launched "
                                 f"{runs['none']['launches']}")
    a = np.asarray(train["none"]["losses"])
    b = np.asarray(train["host"]["losses"])
    rel = (np.abs(b - a) / np.abs(a)).tolist()
    if len(a) != MESH["steps"] or max(rel) > MESH_LOSS_REL_TOL:
        raise AssertionError(f"mesh train: losses {b.tolist()} under the "
                             f"mesh, {a.tolist()} without")
    tokens_equal = bool(np.array_equal(serve["host"]["tokens"],
                                       serve["none"]["tokens"]))
    if not tokens_equal:
        raise AssertionError("mesh serve: tokens differ under the mesh")
    for runs in (train, serve):
        for run in runs.values():
            run.pop("tokens", None)
    emit("mesh", nvidia_smi=smi,
         mesh="(1, 1) ('data', 'model') over a world of one (NCCL)",
         train={"arch": MESH["train_arch"], "dtype": "bfloat16",
                "batch": MESH["batch"], "seq": MESH["seq"], **train},
         serve={"arch": MESH["serve_arch"], "batch": MESH["serve_batch"],
                "prompt_len": MESH["prompt_len"], "gen": MESH["gen"],
                **serve},
         loss_rel_diff=rel, loss_tol=MESH_LOSS_REL_TOL,
         losses_bit_equal=bool(np.array_equal(a, b)),
         tokens_equal=tokens_equal,
         process_group_after=False)


def all_kernel_counts() -> dict:
    """Launches of every kernel wrapper (K1-K5, B6, B7) and calls of
    every plain version that counts them."""
    from repro_torch.kernels.lifetime_scan import kernel as k1
    out = {"lifetime_scan": k1.lifetime_scan_sorted.launches,
           **kernel_counts(), **cache_counts()}
    out.update({f"b7_{k}": v for k, v in b7_counts().items()})
    return out


def phase_dryrun(torch, device, smi) -> None:
    """``launch.dryrun.run_cell`` on ``DRYRUN_CELLS``: each ``ok``, with
    ``n_params`` and ``model_flops`` equal to the golden file, nothing
    allocated on the card, no kernel launched, no group left."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    golden = json.loads(GOLDEN_DRYRUN.read_text())["cells"]
    gc.collect()
    torch.cuda.synchronize(device)
    mem0, counts0 = torch.cuda.memory_allocated(device), all_kernel_counts()
    cells = []
    for arch, shape, multi_pod in DRYRUN_CELLS:
        rec = dryrun.run_cell(arch, shape, multi_pod, device=device)
        what = f"dryrun {arch} {shape} {rec['mesh']}"
        if rec["status"] != "ok":
            raise AssertionError(f"{what}: {rec['status']} "
                                 f"{rec.get('error')}\n{rec.get('traceback')}")
        want = golden[arch][shape]
        for key in ("n_params", "model_flops"):
            if rec[key] != want[key]:
                raise AssertionError(f"{what}: {key} {rec[key]} != the "
                                     f"reference's {want[key]}")
        if dist.is_initialized():
            raise AssertionError(f"{what}: a process group is left")
        cells.append({
            "arch": arch, "shape": shape, "mesh": rec["mesh"],
            "lower_s": rec["lower_s"], "total_s": rec["total_s"],
            "n_params": rec["n_params"], "model_flops": rec["model_flops"],
            "dot_flops": rec["hlo_cost"]["dot_flops"],
            "n_dot_sites": rec["hlo_cost"]["n_dot_sites"],
            "bytes": rec["hlo_cost"]["bytes"], "cost": rec["cost"],
            "collective_bytes": rec["collectives"]["by_kind"],
            "collective_count": rec["collectives"]["count"],
            "memory": rec["memory"], "roofline": rec["roofline"],
            "useful_flops_ratio": rec["useful_flops_ratio"]})
    gc.collect()
    torch.cuda.synchronize(device)
    mem1, counts1 = torch.cuda.memory_allocated(device), all_kernel_counts()
    if mem1 != mem0:
        raise AssertionError(f"dryrun: device memory {mem0} -> {mem1} B")
    if counts1 != counts0:
        raise AssertionError(f"dryrun: kernel counts moved {counts0} -> "
                             f"{counts1}")
    emit("dryrun", nvidia_smi=smi, torch=torch.__version__, cells=cells,
         memory_allocated_bytes=[mem0, mem1], kernel_counts=counts1,
         process_group_after=False)


def kernel_label(mangled: str) -> str:
    """``flash_fwd_mma_kernel<64>`` from the mangled name of a kernel of
    the port (anonymous namespace, templated on dtype and head dim)."""
    rest, name = re.sub(r"^_ZN?", "", mangled), None
    while name is None and (m := re.match(r"\d+", rest)):
        n = int(m.group())           # a length-prefixed identifier
        ident, rest = rest[m.end():m.end() + n], rest[m.end() + n:]
        if not ident.startswith("_GLOBAL__N"):    # skip the namespace
            name = ident
    if name is None:
        return mangled
    args = []
    if rest.startswith("I"):
        head = rest.split("EEv")[0]
        if head.startswith("If"):
            args.append("float")
        elif head.startswith("I13__nv_bfloat16"):
            args.append("bf16")
        for kind, value in re.findall(r"L([ib])(\d+)E", head):
            args.append(value if kind == "i" else
                        ("true" if value == "1" else "false"))
    return f"{name}<{', '.join(args)}>" if args else name


def kernel_table(lib: Path) -> dict:
    """{kernel: registers, spill bytes and tensor-core instructions} of one
    built library: ptxas's ``-v`` log beside it, and its SASS by the CUDA
    toolkit's ``cuobjdump -sass`` (``HMMA``/``HGMMA`` lines)."""
    from repro_torch.kernels import _build
    table, name = {}, None
    for line in lib.with_suffix(".log").read_text().splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name = kernel_label(m.group(1))
            table[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) "
                                      r"bytes spill loads", line)):
            table[name]["spill_stores"] = int(m.group(1))
            table[name]["spill_loads"] = int(m.group(2))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            table[name]["registers"] = int(m.group(1))
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    name = None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            name = kernel_label(m.group(1))
            table.setdefault(name, {})["tensor_core_instructions"] = 0
        elif name and re.search(r"\bHG?MMA\.", line):
            table[name]["tensor_core_instructions"] += 1
    return table


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import KERNEL_HEAD_DIMS
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:   # one nvcc per source
        libs = dict(zip(SOURCES, pool.map(_build.build, SOURCES)))
    seconds = time.perf_counter() - t0
    tables = {name: kernel_table(lib) for name, lib in libs.items()}
    # the bf16 K2, K3, K4 and K5 must run on the tensor cores
    mma = {k: v.get("tensor_core_instructions", 0)
           for t in tables.values() for k, v in t.items() if "_mma_" in k}
    want = [f"{k}<{hd}>" for k in MMA_KERNELS for hd in KERNEL_HEAD_DIMS] \
        + list(SSD_MMA_KERNELS)
    if sorted(mma) != sorted(want) or not all(mma.values()):
        raise AssertionError(
            f"build: tensor-core kernels missing or without HMMA: "
            f"{[k for k in want if not mma.get(k)]}; not expected: "
            f"{sorted(set(mma) - set(want))}")
    emit("build", kernels=list(SOURCES), seconds=seconds,
         per_kernel=tables)


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
    seconds = time.perf_counter() - t0
    # the GPU-cache backend's dry run on the card
    from repro_torch.kernels.cache_replay import kernel as b6
    before = b6.cache_replay_sorted.launches
    dry = io.StringIO()
    with contextlib.redirect_stdout(dry):
        rc = cli_main(["profile", "--backend", "gpu", "--dry-run"])
    if rc != 0 or "dry-run ok: backend=cachesim" not in dry.getvalue() or \
            "device=cuda" not in dry.getvalue() or \
            b6.cache_replay_sorted.launches != before + 2:
        raise AssertionError(f"profile --backend gpu --dry-run: rc {rc}, "
                             f"{dry.getvalue()[-300:]}")
    # the graph-walking backend's dry run, analyzed and composed on the card
    tpu_dry = io.StringIO()
    with contextlib.redirect_stdout(tpu_dry):
        rc = cli_main(["profile", "--backend", "tpu", "--dry-run"])
    if rc != 0 or "dry-run ok: backend=tpu_graph subpartitions=['SMEM']" \
            not in tpu_dry.getvalue() or \
            "device=cuda" not in tpu_dry.getvalue():
        raise AssertionError(f"profile --backend tpu --dry-run: rc {rc}, "
                             f"{tpu_dry.getvalue()[-300:]}")
    emit("cli", events=events, seconds=seconds,
         golden="n_layers=2 entry: counts and capacity fractions equal",
         gpu_dry_run=dry.getvalue().strip().splitlines()[-1],
         tpu_dry_run=tpu_dry.getvalue().strip().splitlines()[-1])


def repro_torch_cli(blocked, *argv) -> subprocess.CompletedProcess:
    """``python -m repro_torch <argv>`` in a fresh interpreter with the
    ``blocked`` modules unimportable (``sys.modules[name] = None``); raises
    unless it exits 0."""
    cmd = [sys.executable, "-m", "repro_torch", *argv]
    if blocked:
        cmd = [sys.executable, "-c",
               "import runpy, sys\n"
               f"for name in {list(blocked)!r}:\n"
               "    sys.modules[name] = None\n"
               f"sys.argv = ['repro_torch', *{list(argv)!r}]\n"
               "runpy.run_module('repro_torch', run_name='__main__', "
               "alter_sys=True)\n"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=CHECK_TIMEOUT_S,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    if proc.returncode != 0:
        raise AssertionError(
            f"python -m repro_torch {' '.join(argv)} (blocked: "
            f"{list(blocked)}) exited {proc.returncode}:\n"
            f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    return proc


def phase_check() -> None:
    """The contract analyzer over the checkout's tree, then the planning
    commands without the frameworks they must not import."""
    t0 = time.perf_counter()
    report = json.loads(repro_torch_cli((), "check", "--format",
                                        "json").stdout)
    if report["count"] != 0 or report["rules"] != list(CHECK_RULES):
        raise AssertionError(f"repro_torch check: {report}")
    lines = {}
    for cmd in ("devices", "workloads"):
        out = repro_torch_cli(("torch", "numpy"), cmd).stdout
        if not out.strip():
            raise AssertionError(f"{cmd} without torch and numpy: no output")
        lines[cmd] = len(out.splitlines())
    dry = repro_torch_cli(("torch",), "campaign", "--dry-run").stdout
    if "campaign dry-run ok" not in dry:
        raise AssertionError(f"campaign --dry-run without torch: {dry[-500:]}")
    emit("check", rules=report["rules"], findings=report["count"],
         listing_lines_without_torch_numpy=lines,
         campaign_dry_run_without_torch=dry.strip().splitlines()[-1],
         seconds=time.perf_counter() - t0)


def phase_full(torch, np, device, golden) -> dict:
    """The main path at full width and depth; returns what the timing
    phase needs (launch count, the largest sorted subpartition)."""
    import math

    from repro_torch.core import ProfileSession
    from repro_torch.core.lifetime import (_to_device, lifetimes_of_trace,
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
    reset_b7_counts()

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
    b7 = b7_counts()

    # the entry's time split into its steps, each ended by a synchronize,
    # summed over the subpartitions (after the main path's count is read)
    split = dict.fromkeys(("copy_to_card", "sort_and_gather", "kernel",
                           "copy_back"), 0.0)
    for sub in range(len(trace.names)):
        t_sub = trace.select(sub)
        marks = [time.perf_counter()]
        e = torch.from_numpy(ie).to(device)
        t = _to_device(t_sub.time_cycles, torch.int64, device)
        a = _to_device(t_sub.addr, torch.int64, device)
        w = _to_device(t_sub.is_write, torch.bool, device)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        order = sort_by_addr_time(t, a)
        t, a, w = t[order], a[order], w[order]
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        hist, stats = k.lifetime_scan_sorted(t, a, w, e)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        hist, stats = hist.cpu(), stats.cpu()
        marks.append(time.perf_counter())
        for key, t0_, t1_ in zip(split, marks, marks[1:]):
            split[key] += t1_ - t0_
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
    if b7 != compose_b7_counts(session):
        raise AssertionError(f"full: compose made B7 calls {b7}, expected "
                             "one refresh-free launch and one retention "
                             "pass (the baselines) per subpartition")

    emit("full", arch=run["arch"], n_layers=FULL_LAYERS, seq=run["seq"],
         pe=run["pe"], dataflow=run["dataflow"], events=trace.n_events,
         subpartition_events={n: int((trace.subpartition == i).sum())
                              for i, n in enumerate(trace.names)},
         host_profile_s=t1 - t0, analyze_s=t2 - t1,
         device_extract_s=extract_s, compose_s=t3 - t2, b7_launches=b7,
         kernel_entry_s=kernel_s, kernel_entry_split_s=split,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         lifetime_scan_launches=launches,
         golden=f"n_layers={FULL_LAYERS} entry: counts, histogram, "
                "sum_lt, max_lt and capacity fractions equal")

    t = torch.from_numpy(biggest.time_cycles).to(device)
    a = torch.from_numpy(biggest.addr).to(device)
    w = torch.from_numpy(biggest.is_write).to(device)
    order = sort_by_addr_time(t, a)
    return {"launches": launches, "b7": b7,
            "sorted": (t[order], a[order], w[order]),
            "edges": torch.from_numpy(ie).to(device),
            "session": session}


def device_kernels_per_call(torch, fn, calls: int) -> dict:
    """{device op: {launches, device_us} per call} of ``fn`` on the card,
    from a ``torch.profiler`` trace of ``calls`` calls after a warm-up;
    empty if the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.name
        for short in PROFILED_KERNELS:          # the mangled signature
            if short in name:
                name = short
        n, us = out.get(name, (0, 0.0))
        out[name] = (n + 1, us + ev.time_range.elapsed_us())
    return {k: {"launches": n / calls, "device_us": us / calls}
            for k, (n, us) in out.items()}


# run by a fresh interpreter: argv[1] holds K1's inputs at the subpartition
PROFILE_K1 = """
import json, sys
import torch
import chip_smoke as cs
from repro_torch.kernels.lifetime_scan import kernel as k
t, a, w, e = (x.cuda() for x in torch.load(sys.argv[1]))
print(json.dumps(cs.device_kernels_per_call(
    torch, lambda: k.lifetime_scan_sorted(t, a, w, e), calls=10)))
"""

# run by a fresh interpreter: argv[1] holds B6's inputs at a level, argv[2]
# its ways; both write policies (each picks its own kernels)
PROFILE_B6 = """
import json, sys
import torch
import chip_smoke as cs
from repro_torch.kernels.cache_replay import kernel as k
p, o, c = (x.cuda() for x in torch.load(sys.argv[1]))
ways = int(sys.argv[2])
print(json.dumps({policy: cs.device_kernels_per_call(
    torch, lambda wa=wa: k.cache_replay_sorted(p, o, c, ways, wa), calls=10)
    for policy, wa in (("write_allocate", True),
                       ("no_write_allocate", False))}))
"""


def profile_fresh(torch, script, tensors, *args) -> dict:
    """The JSON that ``script`` prints, run by a fresh interpreter on
    ``tensors`` (saved to a file, argv[1]) and ``args``: on the H100,
    ``torch.profiler`` (CUPTI) ended this process with a segmentation fault
    when started after the serving and training phases."""
    path = ROOT / "build" / "chip_smoke_profile_inputs.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(tuple(x.cpu() for x in tensors), path)
    try:
        proc = subprocess.run(
            [sys.executable, "-c", script, str(path), *map(str, args)],
            cwd=ROOT, capture_output=True, text=True)
    finally:
        path.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"a profile run exited {proc.returncode}:\n"
                           f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def time_lifetime_scan(torch, full, check) -> dict:
    """K1 at the largest subpartition of the full-depth profiling path,
    then on one segment and on a random trace of the same length."""
    from repro_torch.kernels.lifetime_scan import kernel as k
    t, a, w = full["sorted"]
    edges = full["edges"]
    n, n_bins = t.shape[0], edges.shape[0] - 1

    def call():
        return k.lifetime_scan_sorted(t, a, w, edges)

    def warm(fn):
        for _ in range(200):
            fn()
        torch.cuda.synchronize()

    warm(call)
    ms = statistics.median(cuda_ms(call, runs=20))
    # many calls between two events: the host's time per call hides behind
    # the card's, as when the path runs K1 after its sort
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(50):
        call()
    stop.record()
    torch.cuda.synchronize()
    back_to_back_ms = start.elapsed_time(stop) / 50
    plain_ms = statistics.median(cuda_ms(
        lambda: k.lifetime_scan_plain(t, a, w, edges), runs=5))
    per_call = profile_fresh(torch, PROFILE_K1, (t, a, w, edges))
    hist, stats = call()
    n_segments = int(stats[0] + stats[1])
    live = int(stats[0])
    device = t.device
    others = {}
    for name, trace in (
            ("long_segment", long_segment(LONG_SEGMENT_EVENTS, torch,
                                          device)),
            ("random", random_sorted_trace(n, n // 8, 0.35, seed=7,
                                           torch=torch, device=device))):
        warm(lambda tr=trace: k.lifetime_scan_sorted(*tr, edges))
        others[f"{name}_ms"] = statistics.median(cuda_ms(
            lambda tr=trace: k.lifetime_scan_sorted(*tr, edges), runs=20))
        del trace

    # bytes: every input read once, every output written once
    n_bytes = n * (8 + 8 + 1) + (n_bins + 1) * 8 + n_bins * 8 + 8 * 8
    # operations this data needs: two compares per event for the boundary,
    # one subtraction and a binary search over the edges per live segment,
    # one count per segment
    n_ops = 2 * n + live * (1 + (n_bins + 1).bit_length()) + n_segments
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / INT_OPS_PER_S * 1e3
    slice_, blocks = k.launch_grid(n, n_bins, device)
    kernel_launches = per_call.get("lifetime_scan_kernel", {}).get(
        "launches")
    row = {
        "name": "lifetime_scan", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": full["launches"],
        "max_abs_err": check["max_abs_err"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None, "back_to_back_ms": back_to_back_ms,
        **others,
        "cuda_launches_per_call": kernel_launches,
        "device_kernels_per_call": per_call,
        "grid": {"blocks": blocks, "events_per_warp_slice": slice_},
        "events": n, "segments": n_segments, "bytes": n_bytes,
    }
    return row


def mixed_stream(np):
    """``benchmarks/cachesim_bench.py``'s ``_mixed_stream``: half hot-set
    re-references, half long streaming sweeps, shuffled (host numpy)."""
    n = MIXED["n"]
    rng = np.random.RandomState(MIXED["seed"])
    hot = rng.randint(0, MIXED["hot_lines"], n // 2)
    sweep = np.arange(n - n // 2) % MIXED["sweep_lines"]
    lines = np.concatenate([hot, sweep])
    rng.shuffle(lines)
    w = rng.rand(n) < MIXED["write_fraction"]
    return lines.astype(np.int64), w


def b6_layout(torch, lines, w, n_sets):
    """(packed, offsets, counts) of a stream on the card: B6's inputs."""
    from repro_torch.kernels.cache_replay.ops import partition_by_set
    order, offsets, counts = partition_by_set(lines, n_sets)
    return (lines * 2 + w.to(torch.int64))[order], offsets, counts


def longest_piece(np, offsets, counts, S) -> int:
    """The longest run of one set inside one chunk of S accesses of the
    set-sorted layout: the split replay's chain."""
    o, c = offsets.cpu().numpy(), counts.cpu().numpy()
    o, c = o[c > 0], c[c > 0]
    first = np.minimum(c, S - o % S)            # up to the first chunk edge
    last = np.where(c > first, (o + c - 1) % S + 1, 0)
    middle = np.where(c - first - last > 0, S, 0)
    return int(max(first.max(), last.max(), middle.max())) if len(c) else 0


def lru_one_set(lines, w, ways, wa) -> list:
    """Result words of one set's stream by a plain LRU on the host (an
    ordered dict of line -> dirty, least recent first)."""
    from collections import OrderedDict
    state, out = OrderedDict(), []
    for a, write in zip(lines, w):
        if a in state:
            state.move_to_end(a)
            state[a] |= write
            out.append(1)
        elif not wa and write:
            out.append(0)                        # no-write-allocate miss
        else:
            evict, dirty = (state.popitem(last=False)
                            if len(state) == ways else (-1, False))
            state[a] = write
            out.append(((evict + 1) << 3) | (int(dirty) << 2) | 2)
    return out


def b6_counts_stream(torch, per_set, n_sets, ways, g, device):
    """A stream whose set s has exactly per_set[s] accesses over 3 * ways
    lines, in a random order."""
    per_set = torch.tensor(per_set, device=device)
    n = int(per_set.sum())
    sets = torch.repeat_interleave(torch.arange(n_sets, device=device),
                                   per_set)
    sets = sets[torch.randperm(n, generator=g, device=device)]
    tags = torch.randint(0, 3 * ways, (n,), generator=g, device=device)
    return (sets + n_sets * tags,
            torch.rand(n, generator=g, device=device) < 0.35)


def phase_cache_replay_check(torch, np, device) -> dict:
    """B6 against its plain version on the card, bit for bit, and against
    itself on a second run: random streams over n_sets 1 to 4096 and ways
    1 to 32 under both write policies, a stream in one set, an empty
    stream, line addresses near 2^59 - 1, the 1 M-event mixed stream,
    streams whose sets hold S - 1, S and S + 1 accesses (S the split
    replay's chunk length), and 1 M accesses in one set (its first
    B6_MAX_SLOTS words against the plain version on that prefix, all of
    them against a plain LRU on the host)."""
    from repro_torch.kernels.cache_replay import kernel as k

    def run(lines, w, n_sets, ways, wa, what):
        packed, offsets, counts = b6_layout(torch, lines, w, n_sets)
        before = k.cache_replay_sorted.launches
        got = k.cache_replay_sorted(packed, offsets, counts, ways, wa)
        again = k.cache_replay_sorted(packed, offsets, counts, ways, wa)
        torch.cuda.synchronize()
        n = packed.shape[0]
        if k.cache_replay_sorted.launches != before + 2 * (n > 0):
            raise AssertionError(f"cache_replay {what}: the wrapper did not "
                                 f"count one launch per call")
        if not torch.equal(got, again):
            raise AssertionError(f"cache_replay {what}: two runs differ")
        if not n:
            chain = 0
        elif wa:            # the split replay: the longest piece
            chain = longest_piece(np, offsets, counts,
                                  k.split_plan(n, ways, device)[0])
        else:               # the per-set chain: the longest set
            chain = int(counts.max())
        return (packed, offsets, counts, got,
                {"events": n, "chain_steps": chain,
                 "hits": int((got & 1).sum())})

    def same(got, want, what):
        if not torch.equal(got, want):
            bad = int((got != want).nonzero()[0])
            raise AssertionError(
                f"cache_replay {what}: kernel != plain version at sorted "
                f"position {bad}: {int(got[bad])} vs {int(want[bad])}")

    def check(lines, w, n_sets, ways, wa, what):
        packed, offsets, counts, got, r = run(lines, w, n_sets, ways, wa,
                                              what)
        same(got, k.cache_replay_plain(packed, offsets, counts, ways, wa),
             what)
        return r

    g = torch.Generator(device=device).manual_seed(600)
    cases = 0
    for ways in B6_WAYS:
        for n_sets in B6_SETS:
            n = min(B6_MAX_SLOTS * n_sets // 2, 500_000)
            lines = torch.randint(0, 8 + 3 * n_sets * ways, (n,),
                                  generator=g, device=device)
            if cases % 2:
                lines += 2 ** 31 + 7          # int64 tags past 2**31
            w = torch.rand(n, generator=g, device=device) < 0.35
            for wa in (True, False):
                check(lines, w, n_sets, ways, wa,
                      f"n_sets={n_sets} ways={ways} wa={wa}")
                cases += 1
    structured = []
    lines = torch.randint(0, 64, (4096,), generator=g, device=device)
    w = torch.rand(4096, generator=g, device=device) < 0.35
    mixed_l, mixed_w = (torch.from_numpy(x).to(device)
                        for x in mixed_stream(np))
    top = 2 ** 59 - 1 - torch.randint(0, 3 * 64 * 4, (50_000,), generator=g,
                                      device=device)
    e = torch.zeros(0, dtype=torch.int64, device=device)
    named = [("one_set", (lines * 128, w, 128, 8)),
             ("empty", (e, e.bool(), 128, 8)),
             ("near_2^59", (top, w.repeat(13)[:50_000], 64, 4)),
             ("mixed_1M", (mixed_l, mixed_w, 128, 8))]
    # set counts at S - 1, S and S + 1 (and the three in turn) for the L1
    # and L2 geometries: chunk edges just before, on and just after set
    # edges
    for n_sets, ways in ((128, 8), (2048, 16)):
        S = k.SPLIT_MIN_PER_WAY * ways
        for name, deltas in (("S-1", [-1]), ("S", [0]), ("S+1", [1]),
                             ("S-1,S,S+1", [-1, 0, 1])):
            per_set = [S + deltas[i % len(deltas)] for i in range(n_sets)]
            if k.split_plan(sum(per_set), ways, device)[0] != S:
                raise AssertionError(f"cache_replay {name}: the wrapper's "
                                     f"chunk length is not {S}")
            named.append((f"counts_{name}_{n_sets}x{ways}", (
                *b6_counts_stream(torch, per_set, n_sets, ways, g, device),
                n_sets, ways)))
    for name, args in named:
        for wa in (True, False):
            r = check(*args, wa, f"{name} wa={wa}")
            structured.append({"case": name, "write_allocate": wa, **r})
    # 1 M accesses in one set
    cfg = B6_ONE_SET
    one_l = torch.randint(0, cfg["lines"], (cfg["n"],), generator=g,
                          device=device) * cfg["n_sets"]
    one_w = torch.rand(cfg["n"], generator=g, device=device) < 0.35
    host_l = (one_l // cfg["n_sets"]).tolist()
    host_w = one_w.tolist()
    for wa in (True, False):
        what = f"one_set_1M wa={wa}"
        packed, offsets, counts, got, r = run(
            one_l, one_w, cfg["n_sets"], cfg["ways"], wa, what)
        head = packed[:B6_MAX_SLOTS]          # one set: results are causal
        h_counts = torch.clamp(counts, max=B6_MAX_SLOTS)
        h_offsets = torch.zeros_like(offsets)
        same(got[:B6_MAX_SLOTS], k.cache_replay_plain(
            head, h_offsets, h_counts, cfg["ways"], wa), what + " prefix")
        want = torch.tensor(lru_one_set(host_l, host_w, cfg["ways"], wa),
                            dtype=torch.int64, device=device)
        # the host LRU reports line numbers within the set; the kernel
        # reports line addresses
        ev = (want >> 3) - 1
        want = torch.where(ev >= 0, ((ev * cfg["n_sets"] + 1) << 3)
                           | (want & 7), want)
        same(got, want, what + " against the host LRU")
        structured.append({"case": "one_set_1M", "write_allocate": wa,
                           "checked": f"first {B6_MAX_SLOTS} against the "
                                      f"plain version, all against a "
                                      f"plain LRU on the host", **r})
    emit("kernel_check", kernel="cache_replay", cases=cases,
         ways=list(B6_WAYS), n_sets=list(B6_SETS),
         structured=structured, repeat_runs="bit-equal",
         chain_steps_is="under write-allocate the longest run of one set "
                        "inside one chunk of the split replay, otherwise "
                        "the longest set",
         tolerance="exact (int64 result words)", max_abs_err=0)
    return {"max_abs_err": 0}


def b7_trace(torch, np, device, seg_len, seed, boundary_rets=()):
    """One subpartition's arrays for the policy kernels on the card, built
    from segment lengths (one address each, in address order): lifetimes
    lognormal around the gain cells' retentions (some exactly at
    ``k * ret`` for ``ret`` in ``boundary_rets``), integer reads and bits
    (256 or 1024, as traces carry), the value-sorted side with its prefix
    sums and the address side with its per-address sums."""
    rng = np.random.RandomState(seed)
    seg_len = np.asarray(seg_len, np.int64)
    L, A = int(seg_len.sum()), len(seg_len)
    lt = rng.lognormal(np.log(2e-6), 2.0, L)
    if boundary_rets:
        rets = np.asarray(boundary_rets)
        pick = rng.rand(L) < 0.5
        k = rng.randint(1, 9, L).astype(np.float64)
        lt[pick] = (k * rets[rng.randint(0, len(rets), L)])[pick]
    reads = rng.poisson(3.0, L).astype(np.float64)
    bits = np.where(rng.rand(L) < 0.8, 256.0, 1024.0)
    seg = np.repeat(np.arange(A, dtype=np.int32), seg_len)
    starts = np.concatenate([[0], np.cumsum(seg_len)[:-1]])
    rb = reads * bits
    order = np.argsort(lt, kind="stable")
    pb = np.concatenate([[0.0], np.cumsum(bits[order])])
    prb = np.concatenate([[0.0], np.cumsum(rb[order])])
    maxlt = np.sort(np.maximum.reduceat(lt, starts))

    def put(a, dt=torch.float64):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)

    return {"L": L, "A": A,
            "value": (put(lt[order]), put(pb), put(prb), put(maxlt)),
            "addr": (put(lt), put(rb), put(bits), put(seg, torch.int32),
                     put(np.add.reduceat(bits, starts)),
                     put(np.add.reduceat(rb, starts)))}


def b7_candidates(torch, np, device, C, D, seed, pool=None, rets=()):
    """[C, D] candidates on the card with NaN in every padded slot (a slot
    the kernels must never read): retentions lognormal around the
    lifetimes, some infinite (SRAM) or from ``rets``, energies 0.5-20 fJ;
    ``pool`` (a list of (ret, read_fj, write_fj) devices) draws devices
    from it instead."""
    rng = np.random.RandomState(seed)
    n_dev = rng.randint(1, D + 1, C).astype(np.int32)
    n_dev[0] = D
    ret = np.full((C, D), np.nan)
    rf = np.full((C, D), np.nan)
    wf = np.full((C, D), np.nan)
    for c in range(C):
        for d in range(n_dev[c]):
            if pool is not None:
                ret[c, d], rf[c, d], wf[c, d] = pool[rng.randint(len(pool))]
                continue
            u = rng.rand()
            ret[c, d] = (np.inf if u < 0.15 else
                         rets[rng.randint(len(rets))] if u < 0.4 and rets
                         else rng.lognormal(np.log(2e-6), 2.0))
            rf[c, d], wf[c, d] = rng.uniform(0.5, 20.0, 2)

    def put(a, dt=torch.float64):
        return torch.from_numpy(a).to(device, dt)

    return put(ret), put(rf), put(wf), put(n_dev, torch.int32)


def b7_index(torch, np, cands):
    """The retention index of [C, D] candidates on the card: host arrays
    and their tensors on the candidates' device."""
    from repro_torch.kernels.compose_policy import ops
    ret, n_dev = cands[0], cands[3]
    D = ret.shape[1]
    pad = np.arange(D)[None, :] >= n_dev.cpu().numpy()[:, None]
    ret_u, ridx = ops.retention_index(ret.cpu().numpy(), pad)
    return {"ret_u_host": ret_u, "ridx_host": ridx,
            "ret_u": torch.from_numpy(ret_u).to(ret.device),
            "ridx": torch.from_numpy(ridx).to(ret.device)}


def b7_runs(torch, np, cands, value, addr, orig=None) -> list:
    """(name, wrapper, plain, args, kinds) of every B7 kernel on one input:
    the refresh-free kernel, the retention pass with and without address
    groups, the decision per address, and both candidate passes once per
    retention group (``orig``: the ungrouped pass's lifetimes, by default
    the address-sorted ones).  ``kinds`` says per output whether it is
    compared exactly (counts, picks, per-address sums), summed per row
    within B7_ENERGY_RTOL (energy partials) or summed per row and compared
    exactly below B7_FLOOR_EXACT_BELOW (floor partials)."""
    from repro_torch.kernels.compose_policy import kernel as k
    from repro_torch.kernels.compose_policy import ops
    idx = b7_index(torch, np, cands)
    _, rf, wf, n_dev = cands
    lt, rb, bits, seg, abits, arbits = addr
    A = int(abits.shape[0])
    dev = lt.device
    runs = [("refresh-free", k.policy_rf, k.policy_rf_plain,
             (*cands, *value), ("sum", "exact"))]
    ret_u, ridx = idx["ret_u"], idx["ridx"]
    if len(idx["ret_u_host"]):        # R = 0 launches nothing
        runs += [("retention pass", k.policy_retention,
                  k.policy_retention_plain, (ret_u, lt, bits, seg, A),
                  ("exact", "floor")),
                 ("retention pass without addresses", k.policy_retention,
                  k.policy_retention_plain, (ret_u, lt, bits),
                  ("exact", "floor"))]
    rs = k.policy_retention_plain(ret_u, lt, bits, seg, A)[0]
    runs.append(("decide", k.policy_ra_decide, k.policy_ra_decide_plain,
                 (ridx, rf, wf, n_dev, rs, abits, arbits), ("exact",)))
    o_lt, o_rb, o_bits = orig if orig is not None else (lt, rb, bits)
    for lo, hi, rows in ops.retention_groups(idx["ridx_host"],
                                             len(idx["ret_u_host"])):
        u, r = ops._local_index(idx["ret_u_host"], idx["ridx_host"], lo, hi,
                                rows)
        local = (torch.from_numpy(u).to(dev), torch.from_numpy(r).to(dev),
                 rf[lo:hi], wf[lo:hi], n_dev[lo:hi])
        runs += [(f"grouped candidates {lo}:{hi}", k.policy_ra_grouped,
                  k.policy_ra_grouped_plain, (*local, lt, rb, bits),
                  ("sum",)),
                 (f"ungrouped candidates {lo}:{hi}", k.policy_ra_ungrouped,
                  k.policy_ra_ungrouped_plain, (*local, o_lt, o_rb, o_bits),
                  ("sum", "exact"))]
    return runs


def b7_compare(torch, got, want, kinds, what) -> float:
    """A policy kernel's output against its plain version's: each output
    exactly, or summed per row (see b7_runs); returns the largest relative
    difference of the summed ones."""
    if isinstance(want, torch.Tensor):
        got, want = (got,), (want,)
    worst = 0.0
    for i, (g, w, kind) in enumerate(zip(got, want, kinds)):
        if w is None:
            if g is not None:
                raise AssertionError(f"compose_policy {what}: output {i} "
                                     "should be None")
            continue
        if kind == "exact":
            if not torch.equal(g, w):
                bad = (g != w).nonzero()[0].tolist()
                raise AssertionError(
                    f"compose_policy {what}: output {i} differs from the "
                    f"plain version at {bad}: {g[tuple(bad)].item()} vs "
                    f"{w[tuple(bad)].item()}")
            continue
        gs = g.sum(dim=-1) if g.dim() > 1 else g
        ws = w.sum(dim=-1) if w.dim() > 1 else w
        if kind == "floor":
            small = ws < B7_FLOOR_EXACT_BELOW
            if not torch.equal(gs[small], ws[small]):
                raise AssertionError(f"compose_policy {what}: floor sums "
                                     "below 2**53 differ from the plain "
                                     "version")
            gs, ws = gs[~small], ws[~small]
        err = float(((gs - ws).abs() / ws.abs().clamp_min(1e-300)).max()) \
            if ws.numel() else 0.0
        if not err <= B7_ENERGY_RTOL:
            raise AssertionError(f"compose_policy {what}: output {i} off by "
                                 f"{err} relative")
        worst = max(worst, err)
    return worst


def b7_check_case(torch, np, cands, trace, what) -> dict:
    """Each policy kernel twice (bit-equal) and against its plain version
    on the card (see b7_runs and b7_compare)."""
    def same(a, b):
        if isinstance(a, torch.Tensor):
            a, b = (a,), (b,)
        return all(x is None and y is None or torch.equal(x, y)
                   for x, y in zip(a, b))

    worst = 0.0
    idx = b7_index(torch, np, cands)
    for name, fn, plain, args, kinds in b7_runs(torch, np, cands,
                                                trace["value"],
                                                trace["addr"]):
        before = fn.launches
        got = fn(*args)
        again = fn(*args)
        torch.cuda.synchronize()
        if fn.launches != before + 2:
            raise AssertionError(f"compose_policy {what} {name}: the wrapper "
                                 "did not launch once per call")
        if not same(got, again):
            raise AssertionError(f"compose_policy {what} {name}: two runs "
                                 "differ")
        worst = max(worst, b7_compare(torch, got, plain(*args), kinds,
                                      f"{what} {name}"))
    return {"case": what, "L": trace["L"], "A": trace["A"],
            "C": int(cands[0].shape[0]), "D": int(cands[0].shape[1]),
            "R": len(idx["ret_u_host"]), "energy_max_rel_err": worst}


def phase_compose_policy_check(torch, np, device) -> dict:
    """B7 against its plain versions on the card: random grids at D 1-16
    over random address structures, then one address holding every
    lifetime, a million one-lifetime addresses, addresses crossing many
    block ranges and segment lengths at the kernel's range and thread
    sizes, lifetimes exactly at k * ret, SRAM's infinite retention, the
    SOT-MRAM asymmetric fixture; padded slots hold NaN throughout."""
    from repro_torch.devices import get_device_family
    from repro_torch.kernels.compose_policy import kernel as k
    lib = k._launcher()
    rng_len = lib.compose_policy_range_lifetimes()
    thr_len = lib.compose_policy_thread_lifetimes()
    rng = np.random.RandomState(800)
    detail = []
    for i in range(12):
        mean = (1, 3, 40, 5000)[i % 4]
        L = int(rng.randint(1, 300_000))
        seg_len = rng.geometric(1.0 / mean, L)
        seg_len = seg_len[:np.searchsorted(np.cumsum(seg_len), L) + 1]
        seg_len[-1] -= seg_len.sum() - L
        seg_len = seg_len[seg_len > 0]
        D = int(rng.randint(1, 17)) if i else 16
        C = int(rng.randint(1, 41))
        detail.append(b7_check_case(
            torch, np, b7_candidates(torch, np, device, C, D, 900 + i),
            b7_trace(torch, np, device, seg_len, 1000 + i),
            f"random mean_segment={mean}"))
    exact = (2.0 ** -20, 3 * 2.0 ** -21, 5 * 2.0 ** -22)
    fam = (get_device_family("sram-gaincell-default").build()
           + get_device_family("sot-mram").build()[1:])
    asym = [(d.retention_s, d.read_fj_per_bit, d.write_fj_per_bit)
            for d in fam]
    cross = [1, 700_001, 3, rng_len, rng_len - 1, rng_len + 1, thr_len,
             thr_len - 1, thr_len + 1, 2 * rng_len - 1, 2 * rng_len + 1,
             300_000, thr_len * 5 + 1]
    structured = [
        ("one_address_2M", [2_000_000], {}, {}),
        ("million_one_lifetime_addresses", [1] * 1_000_000, {}, {}),
        ("crossing_many_ranges", cross, {}, {}),
        ("segments_at_range_and_thread_sizes",
         [rng_len, thr_len, 1, rng_len, thr_len, thr_len, rng_len + thr_len]
         * 37, {}, {}),
        ("lifetimes_at_k_ret", rng.geometric(1 / 30, 6000),
         {"boundary_rets": exact}, {"rets": exact}),
        ("sot_mram_asymmetric", rng.geometric(1 / 50, 4000), {},
         {"pool": asym}),
    ]
    for j, (what, seg_len, tkw, ckw) in enumerate(structured):
        D = 4 if "sot" in what else int((3, 8, 16, 5, 4, 4)[j])
        detail.append(b7_check_case(
            torch, np, b7_candidates(torch, np, device, 24, D, 950 + j,
                                     **ckw),
            b7_trace(torch, np, device, seg_len, 1100 + j, **tkw), what))
    # SRAM alone, and infinite retention in every slot
    tr = b7_trace(torch, np, device, rng.geometric(1 / 20, 3000), 1200)
    inf = torch.full((3, 4), torch.inf, dtype=torch.float64, device=device)
    en = torch.tensor([[15.0, 1.0, 2.0, 3.0]] * 3, dtype=torch.float64,
                      device=device)
    nd = torch.tensor([1, 4, 2], dtype=torch.int32, device=device)
    detail.append(b7_check_case(torch, np, (inf, en, en.flip(1), nd), tr,
                                "sram_infinite_retention"))
    worst = max(d["energy_max_rel_err"] for d in detail)
    emit("kernel_check", kernel="compose_policy", cases=len(detail),
         detail=detail, repeat_runs="bit-equal energy, counts, picks and "
                                    "refresh sums",
         tolerance=B7_TOLERANCE, max_rel_err=worst)
    return {"max_rel_err": worst}


def reset_b7_counts():
    from repro_torch.kernels.compose_policy import kernel as k
    for fn in k.KERNELS:
        fn.launches = 0
    for fn in k.PLAIN:
        fn.calls = 0


def b7_counts() -> dict:
    """Each B7 kernel's launches under its key, and every plain-version
    call summed under "plain"."""
    from repro_torch.kernels.compose_policy import kernel as k
    out = {"rf": k.policy_rf.launches,
           "retention": k.policy_retention.launches,
           "ra_grouped": k.policy_ra_grouped.launches,
           "ra_decide": k.policy_ra_decide.launches,
           "ra_ungrouped": k.policy_ra_ungrouped.launches}
    out["plain"] = sum(fn.calls for fn in k.PLAIN)
    return out


def live_subpartitions(session) -> int:
    """Subpartitions with lifetimes: each makes one B7 call per compose
    (an empty one is composed on the host)."""
    return sum(len(st.lifetimes_s) > 0 for st, _ in session._stats.values())


def compose_b7_counts(session) -> dict:
    """A fresh session's compose step: per subpartition with lifetimes one
    refresh-free launch and one retention pass (its monolithic
    baselines), nothing else."""
    n = live_subpartitions(session)
    return {"rf": n, "retention": n, "ra_grouped": 0, "ra_decide": 0,
            "ra_ungrouped": 0, "plain": 0}


def sweep_contract(torch_pts, numpy_pts, what) -> float:
    """Capacity fractions and bank quantization bit-identical; energy,
    monolithic baselines and energy_vs_sram within SWEEP_ENERGY_RTOL;
    returns the largest relative difference."""
    import numpy as np
    if len(torch_pts) != len(numpy_pts):
        raise AssertionError(f"sweep {what}: point counts differ")
    worst = 0.0
    for a, b in zip(torch_pts, numpy_pts):
        ca, cb = a.composition, b.composition
        if (a.candidate, a.subpartition) != (b.candidate, b.subpartition) \
                or not np.array_equal(ca.capacity_fractions,
                                      cb.capacity_fractions) \
                or ca.quantization != cb.quantization:
            raise AssertionError(
                f"sweep {what} {a.subpartition}/{a.candidate}: capacity "
                f"{ca.capacity_fractions} != numpy {cb.capacity_fractions}")
        # energy, the monolithic baselines (on the torch engine from the
        # retention pass's floor sums) and energy_vs_sram
        pairs = [("energy_j", ca.energy_j, cb.energy_j),
                 ("energy_vs_sram", ca.energy_vs_sram, cb.energy_vs_sram)]
        if sorted(ca.monolithic_energy_j) != sorted(cb.monolithic_energy_j):
            raise AssertionError(f"sweep {what}: baselines of other devices")
        pairs += [(f"monolithic_energy_j[{d}]", e, cb.monolithic_energy_j[d])
                  for d, e in ca.monolithic_energy_j.items()]
        for field, x, y in pairs:
            err = abs(x - y) / abs(y)
            if not err <= SWEEP_ENERGY_RTOL:
                raise AssertionError(f"sweep {what} {a.subpartition}/"
                                     f"{a.candidate}: {field} off by {err}")
            worst = max(worst, err)
    return worst


def timed_sweep(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def two_layer_systolic(torch):
    """The 2-layer TinyLlama systolic session (the registry's default
    depth), profiled and analyzed on the card."""
    from repro_torch.core import ProfileSession
    from repro_torch.workloads import get_workload
    run = json.loads(GOLDEN.read_text())["run"]
    workload, cfg = get_workload(run["arch"]).with_params(
        seq=run["seq"], n_layers=2).build(run["backend"])
    session = ProfileSession(run["backend"])
    session.profile(workload, rows=run["pe"], cols=run["pe"],
                    dataflow=run["dataflow"], **cfg).analyze()
    return "systolic@2", session


def two_layer_gpu(torch):
    """The golden file's 2-layer TinyLlama entry of the GPU-cache path."""
    from repro_torch.core import ProfileSession
    from repro_torch.workloads import get_workload
    entry = json.loads(GOLDEN_GPU.read_text())["entries"]["tinyllama_1_1b@2"]
    program, cfg = get_workload(entry["workload"]).with_params(
        **entry["params"]).build("gpu")
    session = ProfileSession("gpu")
    session.profile(program, **cfg).analyze()
    return "gpu@2", session


def phase_sweep(torch, np, device, name, session, two_layer,
                cli=False) -> dict:
    """The design-space sweep on the card through ``ProfileSession.sweep``
    and ``SweepRunner``, on one path's analyzed full-depth session (the
    ``full`` or the ``gpu`` phase's): ``engine="torch"`` against
    ``engine="numpy"`` on the CLI's default grid for refresh-free,
    refresh-aware and bank-quantized (and refresh-aware without raw
    lifetimes on one subpartition), each call with B7 launches and no
    plain-version call; the wide grid timed on the torch engine, against
    numpy on the path's 2-layer session only; a first call's trace-view
    build and residence upload timed on their own (the session's compose
    already holds both in the memos), the warm wide-grid calls split into
    the kernels, the monolithic baselines and the rest of the host
    epilogue; with ``cli`` the sweep CLI's dry run."""
    from repro_torch.__main__ import main as cli_main
    from repro_torch.compose import engine as ce
    from repro_torch.compose import executor
    from repro_torch.sweep import DeviceGrid, SweepRunner
    grid = DeviceGrid(**SWEEP_GRID)
    wide = DeviceGrid(**SWEEP_WIDE_GRID)

    # a first call's pieces, built afresh beside the memoized ones
    view_s = upload_s = 0.0
    for st, raw in session._stats.values():
        t0 = time.perf_counter()
        view = ce._build_trace_view(st, raw, session._clock_hz)
        t1 = time.perf_counter()
        res = executor.TraceResidence(view, device)
        res.value_sorted(view)
        res.addr_sorted(view)
        torch.cuda.synchronize()
        view_s += t1 - t0
        upload_s += time.perf_counter() - t1
    del view, res
    split = {"trace_view_build_s": view_s, "residence_upload_s": upload_s}

    # the main path: the default grid, every policy, then the stats-only
    # entry (no raw lifetimes) on one subpartition
    reset_b7_counts()                          # main path starts here
    runs, worst = {}, 0.0
    for policy in SWEEP_POLICIES:
        before = b7_counts()
        res_t, t_torch = timed_sweep(torch, lambda: session.sweep(
            grid, policy=policy, engine="torch", attach=False))
        after = b7_counts()
        if after["plain"] != before["plain"] or sum(
                after[key] - before[key] for key in
                B7_LAUNCH_KEYS.values()) == 0:
            raise AssertionError(f"sweep {name} {policy}: B7 launches "
                                 f"{before} -> {after}")
        res_n, t_numpy = timed_sweep(torch, lambda: session.sweep(
            grid, policy=policy, engine="numpy", attach=False))
        worst = max(worst, sweep_contract(res_t.points, res_n.points,
                                          f"{name} {policy}"))
        runs[policy] = {"torch_s": t_torch, "numpy_s": t_numpy,
                        "points": len(res_t)}
    sub, (st, _) = next(iter(session._stats.items()))
    pts_t, t_torch = timed_sweep(torch, lambda: SweepRunner(
        grid, policy="refresh-aware", engine="torch").run_stats(
            st, None, clock_hz=session._clock_hz))
    pts_n, t_numpy = timed_sweep(torch, lambda: SweepRunner(
        grid, policy="refresh-aware", engine="numpy").run_stats(
            st, None, clock_hz=session._clock_hz))
    worst = max(worst, sweep_contract(pts_t, pts_n,
                                      f"{name} {sub} without raw"))
    runs[f"refresh-aware without raw ({sub})"] = {
        "torch_s": t_torch, "numpy_s": t_numpy, "points": len(pts_t)}
    launches = b7_counts()                     # main path ends here
    if launches["plain"] or not all(launches[key] for key in
                                    B7_LAUNCH_KEYS.values()):
        raise AssertionError(f"sweep {name} main path: B7 counts "
                             f"{launches}")

    # the wide grid on the torch engine; its warm wall split into the
    # kernels (CUDA events over the same wrapper calls), the monolithic
    # baselines (the executor's floor_refresh_bits calls, timed in place:
    # the retention pass on a retention not yet memoized, the host
    # lookups) and the rest of the host epilogue; analyze_energy is
    # counted, and must not run
    wide_runs, mono = {}, {"s": 0.0, "calls": 0, "analyze_energy_calls": 0}
    floor_refresh_bits = executor.floor_refresh_bits
    analyze_energy = ce.analyze_energy

    def timed_floor_refresh_bits(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return floor_refresh_bits(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            mono["s"] += time.perf_counter() - t0
            mono["calls"] += 1

    def counted_analyze_energy(*args, **kwargs):
        mono["analyze_energy_calls"] += 1
        return analyze_energy(*args, **kwargs)

    executor.floor_refresh_bits = timed_floor_refresh_bits
    ce.analyze_energy = counted_analyze_energy
    try:
        for policy in ("refresh-free", "refresh-aware"):
            res_w, t_w = timed_sweep(torch, lambda: session.sweep(
                wide, policy=policy, engine="torch", attach=False))
            wide_runs[f"{name} {policy}"] = {"torch_s": t_w,
                                             "points": len(res_w)}
    finally:
        executor.floor_refresh_bits = floor_refresh_bits
        ce.analyze_energy = analyze_energy
    if mono["analyze_energy_calls"]:
        raise AssertionError(f"sweep {name}: the torch engine made "
                             f"{mono['analyze_energy_calls']} analyze_energy "
                             "calls")
    kernel_s = sum(b7_call_ms(torch, np, session, wide, device, policy)
                   for policy in ("refresh-free", "refresh-aware")) / 1e3
    walls = sum(v["torch_s"] for v in wide_runs.values())
    split.update(wide_grid_warm_s=walls, wide_grid_kernels_s=kernel_s,
                 wide_grid_monolithic_baselines_s=mono["s"],
                 wide_grid_monolithic_baseline_calls=mono["calls"],
                 wide_grid_analyze_energy_calls=mono["analyze_energy_calls"],
                 wide_grid_rest_of_epilogue_s=walls - kernel_s - mono["s"])
    name2, session2 = two_layer(torch)
    for policy in ("refresh-free", "refresh-aware"):
        res_t, t_torch = timed_sweep(torch, lambda: session2.sweep(
            wide, policy=policy, engine="torch", attach=False))
        res_n, t_numpy = timed_sweep(torch, lambda: session2.sweep(
            wide, policy=policy, engine="numpy", attach=False))
        worst = max(worst, sweep_contract(
            res_t.points, res_n.points, f"wide {name2} {policy}"))
        wide_runs[f"{name2} {policy}"] = {
            "torch_s": t_torch, "numpy_s": t_numpy, "points": len(res_t)}
    del session2

    fields = {}
    if cli:                                    # the CLI's dry run
        before = b7_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["sweep", "--backend", "systolic", "--dry-run",
                           "--engine", "torch"])
        after = b7_counts()
        if rc != 0 or "sweep ok:" not in buf.getvalue() or \
                after["rf"] == before["rf"] or \
                after["plain"] != before["plain"]:
            raise AssertionError(f"sweep --dry-run --engine torch: rc {rc}, "
                                 f"{buf.getvalue()[-300:]}")
        fields["cli"] = buf.getvalue().strip().splitlines()[-1]
    emit("sweep", session=name,
         lifetimes={sub: int(st.lifetimes_s.shape[0])
                    for sub, (st, _) in session._stats.items()},
         grid={**SWEEP_GRID, "candidates": len(grid)},
         wide_grid={**SWEEP_WIDE_GRID, "candidates": len(wide)}, runs=runs,
         wide_runs=wide_runs, time_split_s=split, launches=launches,
         energy_max_rel_err=worst,
         contract=f"capacity fractions and bank quantization bit-identical "
                  f"to engine=numpy; energy, monolithic baselines and "
                  f"energy_vs_sram within {SWEEP_ENERGY_RTOL}",
         **fields)
    return {"launches": launches, "max_rel_err": worst}


def b7_inputs_of(torch, np, session, grid, device, sub=None) -> dict:
    """The kernel inputs one ``evaluate`` call of ``session``'s
    subpartition ``sub`` (the first by default) hands to B7: candidates,
    retention index, and the residence's value-sorted, address-sorted and
    original-order arrays."""
    from repro_torch.compose import engine as ce
    from repro_torch.compose import executor
    from repro_torch.kernels.compose_policy import ops
    name = sub or next(iter(session._stats))
    st, raw = session._stats[name]
    devs = [sorted(c.devices, key=ce._device_sort_key)
            for c in grid.candidates()]
    n_dev = np.array([len(d) for d in devs])
    d_max = int(n_dev.max())
    mats = np.full((3, len(devs), d_max), np.nan)
    for c, ds in enumerate(devs):
        mats[0, c, :len(ds)] = [d.retention_at(st.write_freq_hz)
                                for d in ds]
        mats[1, c, :len(ds)] = [d.read_fj_per_bit for d in ds]
        mats[2, c, :len(ds)] = [d.write_fj_per_bit for d in ds]
    pad = np.arange(d_max)[None, :] >= n_dev[:, None]
    cands = ops.candidate_tensors(*mats, pad, device)
    view = ce.sorted_trace_view(st, raw, session._clock_hz)
    res = executor._residence_for(view, device)
    return {"sub": name, "cands": cands, **b7_index(torch, np, cands),
            "value": res.value_sorted(view), "addr": res.addr_sorted(view),
            "orig": res.original(st.lifetimes_s,
                                 st.accesses_per_lifetime - 1.0,
                                 st.lifetime_bits)}


def b7_grouped_call(inp):
    """The refresh-aware grouped call's three kernels on ``inp`` (one
    retention group): the retention pass, the candidate pass, the
    decision per address; returns the pick counts."""
    from repro_torch.kernels.compose_policy import kernel as k
    _, rf, wf, n_dev = inp["cands"]
    lt, rb, bits, seg, abits, arbits = inp["addr"]
    rs, _ = k.policy_retention(inp["ret_u"], lt, bits, seg,
                               abits.shape[0])
    k.policy_ra_grouped(inp["ret_u"], inp["ridx"], rf, wf, n_dev, lt, rb,
                        bits)
    return k.policy_ra_decide(inp["ridx"], rf, wf, n_dev, rs, abits, arbits)


def b7_call_ms(torch, np, session, grid, device, policy) -> float:
    """Median ms of the kernel calls one sweep of ``session`` makes under
    ``policy``, summed over its subpartitions (refresh-aware: the three
    kernels of a grouped call)."""
    from repro_torch.kernels.compose_policy import kernel as k
    total = 0.0
    for sub in session._stats:
        inp = b7_inputs_of(torch, np, session, grid, device, sub)
        if policy == "refresh-free":
            def call():
                k.policy_rf(*inp["cands"], *inp["value"])
        else:
            def call():
                b7_grouped_call(inp)
        total += statistics.median(cuda_ms(call, runs=5))
    return total


def b7_check_at(torch, np, device, session, grid, sub, what) -> float:
    """Every B7 kernel on ``session``'s subpartition ``sub`` at ``grid``,
    held against its plain version on the card (see b7_runs); returns the
    largest relative difference of the energy (and of floor sums at or
    above 2**53)."""
    inp = b7_inputs_of(torch, np, session, grid, device, sub)
    worst = 0.0
    for name, fn, plain, args, kinds in b7_runs(
            torch, np, inp["cands"], inp["value"], inp["addr"],
            inp["orig"]):
        worst = max(worst, b7_compare(torch, fn(*args), plain(*args), kinds,
                                      f"{what} {name}"))
    torch.cuda.synchronize()
    return worst


def b7_gpu_skew_check(torch, np, device, session) -> dict:
    """B7 held against its plain version at the wide grid on the
    GPU-cache session's subpartition of most lifetimes (1-3 lifetimes an
    address)."""
    from repro_torch.sweep import DeviceGrid
    sub = max(session._stats,
              key=lambda n: len(session._stats[n][0].lifetimes_s))
    st, raw = session._stats[sub]
    t0 = time.perf_counter()
    err = b7_check_at(torch, np, device, session,
                      DeviceGrid(**SWEEP_WIDE_GRID), sub,
                      "the wide grid, gpu")
    out = {"subpartition": sub, "lifetimes": int(len(st.lifetimes_s)),
           "addresses": int(len(np.unique(raw.numpy().addr))),
           "max_rel_err": err, "seconds": time.perf_counter() - t0}
    emit("kernel_check", kernel="compose_policy at the wide grid, gpu skew",
         **out, tolerance=B7_TOLERANCE)
    return out


def b7_bound(n_bytes, n_ops) -> dict:
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP64_FLOPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def time_compose_policy(torch, np, device, session, check) -> list:
    """B7's rows: each kernel at the wide grid (73 candidates, D = 4, 24
    distinct retentions) on the full-depth systolic subpartition
    (5,592,576 lifetimes, 16 addresses), its output there held against the
    plain version's; their ``launches`` are filled in from the compose and
    sweep phases' main runs."""
    from repro_torch.kernels.compose_policy import kernel as k
    from repro_torch.sweep import DeviceGrid
    wide_grid = DeviceGrid(**SWEEP_WIDE_GRID)
    inp = b7_inputs_of(torch, np, session, wide_grid, device)
    sub = inp["sub"]
    err_here = b7_check_at(torch, np, device, session, wide_grid, sub,
                           "the wide grid, systolic")
    ret, rf, wf, n_dev = inp["cands"]
    C, D = ret.shape
    R = len(inp["ret_u_host"])
    if R > k.MAX_RETENTIONS:
        raise AssertionError(f"the wide grid has {R} distinct retentions")
    real = int(n_dev.sum())                    # real (candidate, device)
    lt, rb, bits, seg, abits, arbits = inp["addr"]
    L, A = int(lt.shape[0]), int(abits.shape[0])
    rs, _ = k.policy_retention(inp["ret_u"], lt, bits, seg, A)
    lib = k._launcher()
    n_ranges = -(-L // lib.compose_policy_range_lifetimes())
    n_blocks = -(-L // lib.compose_policy_candidate_block())
    cand = (inp["ret_u"], inp["ridx"], rf, wf, n_dev)
    slots = C * D * 20 + C * 4                 # rf, wf, ridx; n_dev
    probes = math.ceil(math.log2(L + 1)) + math.ceil(math.log2(A + 1))
    specs = {
        # per real slot: two binary searches over the lifetimes and the
        # addresses, four prefix reads; the candidates in, the energies
        # and counts out
        "compose_policy_rf": (
            "refresh-free", B7_RF_REPLACES, k.policy_rf, k.policy_rf_plain,
            (*inp["cands"], *inp["value"]),
            real * (3 * 8 + 8 * (probes + 4)) + C * 4 + C * 8 + C * D * 8,
            real * (2 * probes + 12)),
        # each lifetime's lt, bits and segment id once, every retention's
        # per-address sums out
        "compose_policy_retention": (
            "retention pass", B7_RA_REPLACES, k.policy_retention,
            k.policy_retention_plain, (inp["ret_u"], lt, bits, seg, A),
            L * 20 + R * 8 + R * A * 8, B7_OPS_RETENTION * R * L),
        # lt, read bits, bits once, the candidates once, the partials out;
        # the energy per real (c, d, l) and the recomputed refresh bits
        "compose_policy_ra_grouped": (
            "grouped candidate pass", B7_RA_REPLACES, k.policy_ra_grouped,
            k.policy_ra_grouped_plain, (*cand, lt, rb, bits),
            L * 24 + R * 8 + slots + C * n_blocks * 8,
            B7_OPS_ENERGY * real * L + B7_OPS_REFRESH * R * L),
        # the per-address sums and per-address bits once, counts out
        "compose_policy_ra_decide": (
            "decide", B7_RA_REPLACES, k.policy_ra_decide,
            k.policy_ra_decide_plain,
            (inp["ridx"], rf, wf, n_dev, rs, abits, arbits),
            R * A * 8 + A * 16 + slots + C * D * 8,
            B7_OPS_ENERGY * real * A),
        # as the grouped pass, in the original order, plus the int8 picks
        "compose_policy_ra_ungrouped": (
            "ungrouped candidate pass", B7_UNGROUPED_REPLACES,
            k.policy_ra_ungrouped, k.policy_ra_ungrouped_plain,
            (*cand, *inp["orig"]),
            L * 24 + R * 8 + slots + C * n_blocks * 8 + C * L,
            B7_OPS_ENERGY * real * L + B7_OPS_REFRESH * R * L),
    }
    rows = []
    for name, (what, replaces, fn, plain, args, n_bytes, n_ops) in \
            specs.items():
        ms = statistics.median(cuda_ms(lambda: fn(*args), runs=10))
        plain_ms = statistics.median(cuda_ms(lambda: plain(*args), runs=3))
        extra = {}
        if name == "compose_policy_retention":
            extra["floor_only_ms"] = statistics.median(cuda_ms(
                lambda: fn(inp["ret_u"], lt, bits), runs=10))
            extra["floor_only_bound"] = b7_bound(
                L * 16 + R * 8 + R * n_ranges * 8, B7_OPS_FLOOR * R * L)
        if name == "compose_policy_ra_grouped":
            # the whole grouped call: retention pass, this, decide
            extra["grouped_call_ms"] = statistics.median(cuda_ms(
                lambda: b7_grouped_call(inp), runs=10))
            extra["grouped_call_bound"] = b7_bound(
                L * 28 + A * 16 + R * 8 + slots + C * D * 8,
                B7_OPS_RETENTION * R * L + B7_OPS_ENERGY * real * (L + A)
                + B7_OPS_REFRESH * R * L)
        if name != "compose_policy_rf":
            extra["old_bound_ms"] = (B7_OPS_OLD * real * L
                                     / FP64_FLOPS_PER_S * 1e3)
        rows.append(kernel_row(
            name, B7_SOURCE, replaces, None, check["max_rel_err"], ms,
            plain_ms, n_bytes, n_ops, FP64_FLOPS_PER_S, None,
            ms_shape={"candidates": C, "device_slots": D,
                      "real_slots": real, "retentions": R, "lifetimes": L,
                      "addresses": A,
                      "at": "the wide grid on the full-depth systolic "
                            f"subpartition {sub}"},
            max_abs_err_is="largest relative energy difference to the "
                           "plain version in kernel_check (counts, picks, "
                           "per-address sums and floor sums below 2**53 "
                           "exact)",
            max_rel_err_at_ms_shape=err_here,
            launches_are="kernel calls in the main runs of the two "
                         "full-depth compose steps (one refresh-free call "
                         "and one retention pass a subpartition) and the "
                         "two sweep phases (3 policies on the default grid "
                         "on each full-depth session, plus one stats-only "
                         "sweep each)",
            library_call="none: no single PyTorch call computes it",
            **extra))
    return rows


def reset_cache_counts():
    from repro_torch.backends import cachesim
    from repro_torch.kernels.cache_replay import kernel as k
    k.cache_replay_sorted.launches = 0
    k.cache_replay_plain.calls = 0
    cachesim._simulate_cache.calls = 0


def cache_counts() -> dict:
    from repro_torch.backends import cachesim
    from repro_torch.kernels.cache_replay import kernel as k
    return {"cache_replay": k.cache_replay_sorted.launches,
            "plain": k.cache_replay_plain.calls,
            "scalar": cachesim._simulate_cache.calls}


def trace_digest(np, t_sub) -> str:
    """SHA-256 of one subpartition's trace in trace order, as
    ``tests/make_torch_golden.py`` writes it."""
    import hashlib
    h = hashlib.sha256()
    for arr, dt in ((t_sub.time_cycles, "<i8"), (t_sub.addr, "<i8"),
                    (t_sub.is_write, "u1"), (t_sub.hit, "u1")):
        h.update(np.ascontiguousarray(np.asarray(arr).astype(dt)).tobytes())
    return h.hexdigest()


def check_gpu_entry(np, session, report, entry, key) -> dict:
    """A gpu session's trace, lifetimes and report against one golden
    entry (the short-lived fraction at 1 us too, exactly: a ratio of
    integer counts); returns {sub: short-lived fraction at 1 us}."""
    from repro_torch.kernels.lifetime_scan.ops import (default_edges,
                                                       integer_edges)
    ie = integer_edges(default_edges())
    trace = session.trace
    if trace.n_events != entry["n_events"]:
        raise AssertionError(f"gpu {key}: {trace.n_events} events, golden "
                             f"{entry['n_events']}")
    short = {}
    for sub, name in enumerate(trace.names):
        g, rep = entry["subpartitions"][name], report["subpartitions"][name]
        t_sub = trace.select(sub)
        host = session.subpartition_stats(name)[1].numpy()
        lt = host.lifetime_cycles[~host.orphan]
        bins = np.searchsorted(ie, lt, side="right") - 1
        n_reads, n_writes = t_sub.counts()
        got = {"n_events": t_sub.n_events, "n_reads": n_reads,
               "n_writes": n_writes,
               "n_hits": int(np.asarray(t_sub.hit).sum()),
               "trace_sha256": trace_digest(np, t_sub),
               "n_lifetimes": rep["n_lifetimes"],
               "unique_addrs": rep["unique_addrs"],
               "orphans": int(host.orphan.sum()), "live": int(len(lt)),
               "hist": np.bincount(bins, minlength=len(ie) - 1).tolist(),
               "sum_lt": int(lt.sum()),
               "max_lt": int(lt.max()) if len(lt) else 0,
               "composition_devices": rep["composition"]["devices"],
               "capacity_fractions":
                   rep["composition"]["capacity_fractions"]}
        for field, value in got.items():
            if value != g[field]:
                raise AssertionError(f"gpu {key} {name}.{field}: {value} != "
                                     f"golden {g[field]}")
        comp = rep["composition"]
        if not all(math.isfinite(v) for v in (
                rep["duration_s"], comp["energy_vs_sram"],
                comp["area_vs_sram"])):
            raise AssertionError(f"gpu {key} {name}: report is not finite")
        short[name] = session.short_lived_fraction(name, 1e-6)
        if short[name] != g["short_lived_fraction_1us"]:
            raise AssertionError(f"gpu {key} {name}: short-lived fraction "
                                 f"at 1 us {short[name]} != golden "
                                 f"{g['short_lived_fraction_1us']}")
    return short


def gpu_time_split(torch, np, device, program, cfg) -> dict:
    """The main run's steps again, one by one, each ended by a
    synchronize; returns the split and B6's inputs at L1 and L2."""
    from repro_torch.backends import cachesim
    from repro_torch.kernels.cache_replay import kernel as k
    from repro_torch.kernels.cache_replay.ops import decode, partition_by_set
    hcfg = cachesim.HierarchyConfig()
    split = dict.fromkeys((
        "host_stream_build", "copy_to_card", "partition_by_set", "b6_l1",
        "b6_l2", "copy_back", "host_l2_composition"), 0.0)
    inputs = {}

    def level(lines, w, geom, tag):
        m = [time.perf_counter()]
        lt = torch.from_numpy(lines).to(device)
        wt = torch.from_numpy(w).to(device)
        torch.cuda.synchronize()
        m.append(time.perf_counter())
        order, offsets, counts = partition_by_set(lt, geom.n_sets)
        packed = (lt * 2 + wt.to(torch.int64))[order]
        torch.cuda.synchronize()
        m.append(time.perf_counter())
        words = k.cache_replay_sorted(packed, offsets, counts, geom.ways,
                                      hcfg.write_allocate)
        torch.cuda.synchronize()
        m.append(time.perf_counter())
        out = torch.empty_like(words)
        out[order] = words
        result = decode(out.cpu().numpy())
        m.append(time.perf_counter())
        for key, a, b in zip(("copy_to_card", "partition_by_set", tag,
                              "copy_back"), m, m[1:]):
            split[key] += b - a
        inputs[tag] = (packed, offsets, counts, geom.ways)
        return result

    t0 = time.perf_counter()
    (t, a, w), _ = cachesim.stream_of(program, cfg["sample"])
    lines = a // hcfg.l1.line_bytes
    split["host_stream_build"] = time.perf_counter() - t0
    l1 = level(lines, w, hcfg.l1, "b6_l1")
    t0 = time.perf_counter()
    l2 = cachesim.l2_stream(t, lines, w, l1, hcfg)
    split["host_l2_composition"] += time.perf_counter() - t0
    hit2 = level(l2[1], l2[2], hcfg.l2, "b6_l2")[0]
    t0 = time.perf_counter()
    cachesim.merge_levels(t, lines, w, l1[0], l2, hit2, hcfg)
    split["host_l2_composition"] += time.perf_counter() - t0
    return split, inputs


def phase_gpu(torch, np, device) -> dict:
    """The GPU-cache path through its entry points: ``ProfileSession("gpu")``
    -> analyze -> compose, TinyLlama-1.1B at 22 layers first (the main
    run), then the 2-layer entry and every mlperf workload; each run held
    against the golden file, with exactly two B6 launches and no plain or
    scalar replay."""
    from repro_torch.core import ProfileSession
    from repro_torch.workloads import get_workload

    golden = json.loads(GOLDEN_GPU.read_text())
    keys = [GPU_MAIN] + [k for k in golden["entries"] if k != GPU_MAIN]
    runs, main = {}, None
    for key in keys:
        entry = golden["entries"][key]
        spec = get_workload(entry["workload"]).with_params(**entry["params"])
        program, cfg = spec.build("gpu")
        if cfg != entry["backend_cfg"]:
            raise AssertionError(f"gpu {key}: run kwargs {cfg} != golden "
                                 f"{entry['backend_cfg']}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_cache_counts()                 # main path starts here
        reset_b7_counts()
        session = ProfileSession("gpu")
        t0 = time.perf_counter()
        session.profile(program, **cfg)
        t1 = time.perf_counter()
        session.analyze()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        session.compose()
        t3 = time.perf_counter()
        counts = cache_counts()              # main path ends here
        b7 = b7_counts()
        peak = torch.cuda.max_memory_allocated()
        if counts != {"cache_replay": 2, "plain": 0, "scalar": 0}:
            raise AssertionError(f"gpu {key}: replays {counts}, expected two "
                                 "B6 launches and no plain or scalar call")
        if b7 != compose_b7_counts(session):
            raise AssertionError(f"gpu {key}: compose made B7 calls {b7}, "
                                 "expected one refresh-free launch and one "
                                 "retention pass per subpartition")
        short = check_gpu_entry(np, session, session.report(), entry, key)
        runs[key] = {
            "events": {n: int((session.trace.subpartition == i).sum())
                       for i, n in enumerate(session.trace.names)},
            "profile_s": t1 - t0, "analyze_s": t2 - t1,
            "compose_s": t3 - t2, "launches": counts, "b7_launches": b7,
            "max_memory_allocated": peak,
            "short_lived_fraction_1us": short}
        if key == GPU_MAIN:
            main = (program, cfg)
            main_session = session
        del session
    # the main run's wall split into its steps (after its counts are read)
    split, inputs = gpu_time_split(torch, np, device, *main)
    split["analyze"] = runs[GPU_MAIN]["analyze_s"]
    split["compose"] = runs[GPU_MAIN]["compose_s"]
    emit("gpu", main=GPU_MAIN, hierarchy="HierarchyConfig() (128 KB / "
         "8-way L1, 4 MB / 16-way L2, 128 B lines, write-allocate)",
         runs=runs, main_time_split_s=split,
         golden="every entry: trace digests, counts, histograms, sum_lt, "
                "max_lt and capacity fractions equal")
    return {"launches": runs[GPU_MAIN]["launches"]["cache_replay"],
            "b7": runs[GPU_MAIN]["b7_launches"],
            "inputs": inputs, "session": main_session}


def time_cache_replay(torch, np, device, gpu, check) -> dict:
    """B6 at the L1 and L2 shapes of the GPU-cache path's main run, on the
    1 M-event mixed stream and on 1 M accesses in one set (write-allocate,
    the path's policy: the split replay); the plain version at the mixed
    stream (at the L1 shape its slot loop runs 47 k steps of eager
    launches); the CUDA kernels a call from a profiler trace."""
    from repro_torch.kernels.cache_replay import kernel as k

    def timed(packed, offsets, counts, ways):
        return statistics.median(cuda_ms(
            lambda: k.cache_replay_sorted(packed, offsets, counts, ways,
                                          True), runs=20))

    def split(packed, offsets, counts, ways):
        S, chunks = k.split_plan(packed.shape[0], ways, device)
        return {"S": S, "segments": chunks,
                "chain_steps": longest_piece(np, offsets, counts, S)}

    l1, l2 = gpu["inputs"]["b6_l1"], gpu["inputs"]["b6_l2"]
    ms_l1, ms_l2 = timed(*l1), timed(*l2)
    lines, w = (torch.from_numpy(x).to(device) for x in mixed_stream(np))
    mixed = (*b6_layout(torch, lines, w, 128), 8)
    ms_mixed = timed(*mixed)
    cfg = B6_ONE_SET
    g = torch.Generator(device=device).manual_seed(601)
    one_l = torch.randint(0, cfg["lines"], (cfg["n"],), generator=g,
                          device=device) * cfg["n_sets"]
    one_w = torch.rand(cfg["n"], generator=g, device=device) < 0.35
    one = (*b6_layout(torch, one_l, one_w, cfg["n_sets"]), cfg["ways"])
    ms_one = timed(*one)
    plain_ms = statistics.median(cuda_ms(
        lambda: k.cache_replay_plain(*mixed, True), runs=3))
    per_call = profile_fresh(torch, PROFILE_B6, l1[:3], l1[3])
    per_call_wa = per_call["write_allocate"]

    def bound(packed, offsets, counts, ways):
        n, n_sets = packed.shape[0], offsets.shape[0]
        # 8 B read and 8 B written per access, offsets and counts read once
        n_bytes = 16 * n + 16 * n_sets
        # a tag compare and a stamp compare per way, a few for the update
        n_ops = n * (2 * ways + 8)
        return n_bytes, n_ops

    def bound_ms(*level):
        n_bytes, n_ops = bound(*level)
        return max(n_bytes / HBM_BYTES_PER_S, n_ops / INT_OPS_PER_S) * 1e3

    n_bytes, n_ops = bound(*l1)
    s1, s2, s3, s4 = split(*l1), split(*l2), split(*mixed), split(*one)
    row = kernel_row(
        "cache_replay", B6_SOURCE, B6_REPLACES, gpu["launches"],
        check["max_abs_err"], ms_l1, plain_ms, n_bytes, n_ops,
        INT_OPS_PER_S, None,
        ms_shape={"events": l1[0].shape[0], "n_sets": l1[1].shape[0],
                  "ways": l1[3], "level": "L1 of the main run",
                  "write_allocate": True},
        chain_steps=s1["chain_steps"], S=s1["S"], segments=s1["segments"],
        chain_steps_is="the longest run of one set inside one chunk of S "
                       "accesses (the split replay's chain); the per-set "
                       "chain kernel's was the longest set",
        cuda_launches_per_call=sum(
            per_call_wa.get(name, {}).get("launches", 0)
            for name in B6_SPLIT_KERNELS),
        cuda_launches_per_call_no_write_allocate=per_call[
            "no_write_allocate"].get(B6_CHAIN_KERNEL, {}).get("launches"),
        device_kernels_per_call=per_call,
        ms_l2=ms_l2, l2_events=l2[0].shape[0],
        l2_chain_steps=s2["chain_steps"], l2_S=s2["S"],
        l2_segments=s2["segments"],
        ms_1m_mixed=ms_mixed, mixed_chain_steps=s3["chain_steps"],
        mixed_S=s3["S"], mixed_segments=s3["segments"],
        ms_one_set_1m=ms_one, one_set_chain_steps=s4["chain_steps"],
        one_set_S=s4["S"], one_set_segments=s4["segments"],
        one_set_shape=dict(cfg),
        plain_ms_shape="the 1 M-event mixed stream (128 sets x 8 ways)",
        library_call="none: no PyTorch call computes an LRU replay")
    row["bound_ms_l2"] = bound_ms(*l2)
    row["bound_ms_1m_mixed"] = bound_ms(*mixed)
    row["bound_ms_one_set_1m"] = bound_ms(*one)
    return row


def phase_campaign(torch, device) -> dict:
    """The paper's MLPerf + PolyBench campaign through ``CampaignRunner``
    on the card: cold with four threads (the main path: every ``gpu`` job
    two B6 calls, every job's compose and sweep B7), held job by job and in
    the aggregate against the golden file written from the JAX reference;
    a warm rerun that executes nothing; then the process scheduler with two
    worker processes over a subset into a fresh store, byte-identical to
    the thread scheduler's artifacts.  A failed job, a job count other than
    the plan's or a worker exit code other than 0 fails the phase."""
    import tempfile

    from repro_torch.launch.campaign import (CampaignRunner, campaign_facts,
                                             compare_campaign_facts)

    golden = json.loads(GOLDEN_CAMPAIGN.read_text())
    run = golden["run"]
    with tempfile.TemporaryDirectory(prefix="chip-smoke-campaign-") as tmp:
        thread_dir = os.path.join(tmp, "thread")

        def runner(**kw):
            return CampaignRunner(run["workloads"], run["backends"],
                                  device=device, **kw)

        torch.cuda.synchronize()
        reset_cache_counts()                 # main path starts here
        reset_b7_counts()
        t0 = time.perf_counter()
        cold = runner(jobs=CAMPAIGN_THREADS, cache_dir=thread_dir).run()
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        b6 = cache_counts()                  # main path ends here
        b7 = b7_counts()
        labels = [j.label for j in cold.jobs]
        n_gpu = sum(j.backend == "cachesim" for j in cold.jobs)
        if cold.failed or cold.executed != len(labels) or \
                labels != run["jobs"]:
            raise AssertionError(
                f"campaign: {cold.executed} of {len(labels)} jobs executed, "
                f"{cold.failed} failed ({[e for e in cold.errors if e]}), "
                f"plan {labels} against the golden {run['jobs']}")
        if b6 != {"cache_replay": 2 * n_gpu, "plain": 0, "scalar": 0}:
            raise AssertionError(f"campaign: replays {b6}, expected two B6 "
                                 f"launches for each of {n_gpu} gpu jobs")
        if b7["plain"] or not (b7["rf"] and b7["retention"]):
            raise AssertionError(f"campaign: B7 calls {b7}")
        worst = compare_campaign_facts(
            campaign_facts(cold.artifacts, cold.aggregate),
            {"jobs": golden["jobs"], "aggregate": golden["aggregate"]},
            rtol=CAMPAIGN_RTOL)

        t0 = time.perf_counter()
        warm = runner(jobs=CAMPAIGN_THREADS, cache_dir=thread_dir).run()
        warm_s = time.perf_counter() - t0
        if warm.executed or warm.failed or \
                warm.cache_hits != len(labels):
            raise AssertionError(f"campaign warm rerun: {warm.executed} "
                                 f"executed, {warm.failed} failed")

        t0 = time.perf_counter()
        process = CampaignRunner(
            CAMPAIGN_PROCESS["workloads"], run["backends"],
            jobs=CAMPAIGN_PROCESS["workers"], device=device,
            cache_dir=os.path.join(tmp, "process"),
            scheduler="process").run()
        process_s = time.perf_counter() - t0
        m = process.metrics
        if process.failed or process.executed != len(process.jobs) or \
                m["worker_deaths"] or m["worker_exit_codes"] != \
                [0] * CAMPAIGN_PROCESS["workers"]:
            raise AssertionError(
                f"campaign, process scheduler: {process.executed} of "
                f"{len(process.jobs)} executed, {process.failed} failed, "
                f"{m['worker_deaths']} worker deaths, exit codes "
                f"{m['worker_exit_codes']}")
        for job in process.jobs:
            with open(os.path.join(process.store_dir, f"{job.key}.json"),
                      "rb") as a, \
                    open(os.path.join(thread_dir, f"{job.key}.json"),
                         "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"campaign: {job.label}'s artifact "
                                         "differs between the schedulers")

    agg = cold.aggregate["aggregate"]
    bin_1us = "1e-06"
    systolic = agg["systolic"]
    emit("campaign", workloads=run["workloads"], backends=run["backends"],
         jobs=len(labels), systolic_jobs=len(labels) - n_gpu, gpu_jobs=n_gpu,
         threads=CAMPAIGN_THREADS, cold_s=cold_s, warm_s=warm_s,
         warm_executed=warm.executed, b6_launches=b6["cache_replay"],
         b7_launches=b7,
         golden="every job's accesses, short-lived fractions and capacity "
                "fractions and the aggregate exact; sweep area and energy "
                f"within {CAMPAIGN_RTOL}",
         golden_worst_rel_err=worst,
         short_lived_1us={
             "cachesim/L1": agg["cachesim"]["L1"]["short_lived"][bin_1us],
             "cachesim/L2": agg["cachesim"]["L2"]["short_lived"][bin_1us],
             **{f"systolic/{sub}": e["short_lived"][bin_1us]
                for sub, e in systolic.items()},
             "systolic (all buffers, access-weighted)": sum(
                 e["short_lived"][bin_1us] * e["accesses"]
                 for e in systolic.values()) / sum(
                 e["accesses"] for e in systolic.values())},
         process={"workloads": CAMPAIGN_PROCESS["workloads"],
                  "workers": CAMPAIGN_PROCESS["workers"],
                  "jobs": len(process.jobs), "seconds": process_s,
                  "worker_deaths": m["worker_deaths"],
                  "worker_exit_codes": m["worker_exit_codes"],
                  "artifacts": "byte-identical to the thread scheduler's"})
    return {"b6": b6["cache_replay"], "b7": b7}


def host_rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def memo_state(torch) -> dict:
    """Host RSS, device memory in use, and the sizes of the composition
    memos (address groups, trace views, device residences)."""
    from repro_torch.compose import engine as ce
    from repro_torch.compose import executor
    return {"host_rss": host_rss_bytes(),
            "device_allocated": torch.cuda.memory_allocated(),
            "groups": len(ce._groups_memo), "views": len(ce._view_memo),
            "residences": len(executor._residence_memo)}


def check_session_freed(torch, refs, before) -> None:
    """After the last reference to a session is dropped: collect, and check
    that its stats and raw lifetimes (``refs``, weak) are gone and that no
    composition memo holds an entry whose owner is dead."""
    from repro_torch.compose import engine as ce
    from repro_torch.compose import executor
    gc.collect()
    torch.cuda.empty_cache()
    after = memo_state(torch)
    alive = sum(r() is not None for r in refs)
    stale = [name for name, memo in (("groups", ce._groups_memo),
                                     ("views", ce._view_memo),
                                     ("residences", executor._residence_memo))
             for entry in list(memo.values()) if entry[0]() is None]
    emit("free_systolic_session", before=before, after_collect=after,
         stats_and_raw_alive=alive, stale_memo_entries=stale)
    if alive or stale:
        raise AssertionError(f"the freed session's stats/raw alive: {alive}, "
                             f"stale memo entries: {stale}")


def compare_compositions(got, want, what) -> float:
    """Capacity fractions bit-identical, energies and area within
    TPU_ENERGY_RTOL; returns the largest relative difference."""
    import numpy as np
    if tuple(got.devices) != tuple(want.devices) or \
            not np.array_equal(got.capacity_fractions,
                               want.capacity_fractions):
        raise AssertionError(f"{what}: capacity {got.capacity_fractions} "
                             f"!= numpy {want.capacity_fractions}")
    pairs = [(got.energy_j, want.energy_j),
             (got.energy_vs_sram, want.energy_vs_sram),
             (got.area_um2, want.area_um2)]
    pairs += [(got.monolithic_energy_j[d], want.monolithic_energy_j[d])
              for d in want.monolithic_energy_j]
    worst = 0.0
    for g, w in pairs:
        rel = abs(g - w) / max(abs(w), 1e-300)
        if not rel <= TPU_ENERGY_RTOL:
            raise AssertionError(f"{what}: {g} != numpy {w} (rel {rel})")
        worst = max(worst, rel)
    return worst


def phase_tpu(torch, np, device) -> list:
    """The graph-walking backend (``ProfileSession("tpu")``) on the
    framework's own training steps at full width and depth (``tpu_smoke``
    off), through the ``archs`` lowering: the walk captures each step over
    meta tensors, so it must allocate no device memory and launch no
    kernel (the K2 and K5 counts stay put); then analyze on the card and
    compose with ``engine="torch"`` (B7) against ``engine="numpy"``,
    refresh-free and refresh-aware.  Returns the B7 launches of each
    session's compose steps."""
    from repro_torch.backends.tpu_graph import CLOCK_HZ, capture_graph
    from repro_torch.core import ProfileSession
    from repro_torch.workloads import get_workload

    max_sm = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    launches, runs = [], {}
    for arch in TPU["archs"]:
        spec = get_workload(arch).with_params(seq=TPU["seq"],
                                              tpu_smoke=TPU["tpu_smoke"])
        workload, cfg = spec.build("tpu")
        fn, params, batch = workload
        if cfg != {"sample": 4} or batch["tokens"].shape != \
                (TPU["batch"], TPU["seq"]):
            raise AssertionError(f"{arch}: tpu lowering gave {cfg}, "
                                 f"tokens {batch['tokens']}")
        tc = time.perf_counter()
        nodes = len(capture_graph(fn, params, batch).graph.nodes)
        capture_s = time.perf_counter() - tc

        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        counts0 = serving_counts()
        session = ProfileSession("tpu")
        t0 = time.perf_counter()
        session.profile(workload, **cfg)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        if torch.cuda.memory_allocated() != mem0 or \
                torch.cuda.max_memory_allocated() != mem0:
            raise AssertionError(f"{arch}: the walk allocated device memory")
        if serving_counts() != counts0:
            raise AssertionError(f"{arch}: the walk launched a kernel "
                                 f"({counts0} -> {serving_counts()})")
        trace = session.trace
        t = np.asarray(trace.time_cycles)
        if trace.names != ("SMEM",) or not np.all(np.diff(t) >= 0):
            raise AssertionError(f"{arch}: trace contract broken")

        reset_b7_counts()                        # main path starts here
        t2 = time.perf_counter()
        session.analyze()
        t3 = time.perf_counter()
        split, worst, b7 = {}, 0.0, None
        for policy in TPU["policies"]:
            ts = time.perf_counter()
            session.compose(policy=policy)
            torch.cuda.synchronize()
            split[f"{policy}_torch_s"] = time.perf_counter() - ts
            if b7 is None:
                b7 = b7_counts()
                if b7 != compose_b7_counts(session):
                    raise AssertionError(f"{arch}: compose made B7 calls "
                                         f"{b7}")
            comp = session.composition("SMEM")
            ts = time.perf_counter()
            session.compose(policy=policy, engine="numpy")
            split[f"{policy}_numpy_s"] = time.perf_counter() - ts
            worst = max(worst, compare_compositions(
                comp, session.composition("SMEM"), f"tpu {arch} {policy}"))
        total = b7_counts()                      # main path ends here
        if total["plain"] or sum(total.values()) <= sum(b7.values()):
            raise AssertionError(f"{arch}: B7 calls {total}")
        launches.append(total)
        report = session.report()["subpartitions"]["SMEM"]
        runs[arch] = {
            "graph_nodes": nodes, "ops": session.report()["n_ops"],
            "events": trace.n_events, "n_reads": report["n_reads"],
            "n_writes": report["n_writes"],
            "n_lifetimes": report["n_lifetimes"],
            "capture_s": capture_s, "walk_s": t1 - t0,
            "analyze_s": t3 - t2, "compose_s": split,
            "short_lived_1us": session.short_lived_fraction("SMEM", 1e-6),
            "b7_launches": total, "max_rel_energy_err": worst}
        del session, trace
    emit("tpu", seq=TPU["seq"], batch=TPU["batch"], sample=4,
         tpu_smoke=TPU["tpu_smoke"],
         model_clock_hz=CLOCK_HZ, clocks_max_sm=max_sm,
         walk_device_memory="no allocation, no K2/K5 launch",
         gate=f"capacity bit-identical to numpy, energy {TPU_ENERGY_RTOL}",
         runs=runs)
    return launches


def phase_ssd_no_backward(torch, device) -> None:
    """F6: K5 has no backward.  A gradient through ``ops.ssd_scan`` on the
    card raises; the forward launches once and gives what the wrapper
    gives without the gradient, bit for bit."""
    from repro_torch.kernels.ssd_scan import kernel as k
    from repro_torch.kernels.ssd_scan import ops
    for dx in ("float32", "bfloat16"):
        x, dt, A, B, C, D = ssd_inputs(torch, device, 1, 64, 4, 16, 16, dx,
                                       dx, seed=300)
        with torch.no_grad():
            want = ops.ssd_scan(x, dt, A, B, C, D, chunk=32)
        x.requires_grad_(True)
        before = k.ssd_scan_chunked.launches
        y = ops.ssd_scan(x, dt, A, B, C, D, chunk=32)
        torch.cuda.synchronize()
        if k.ssd_scan_chunked.launches != before + 1 or \
                not torch.equal(y.detach(), want):
            raise AssertionError(f"ssd_scan {dx}: the forward moved")
        try:
            y.float().sum().backward()
        except NotImplementedError as err:
            if "no backward" not in str(err):
                raise
        else:
            raise AssertionError(f"ssd_scan {dx}: a backward through K5 "
                                 "did not raise")
    emit("ssd_no_backward", dtypes=["float32", "bfloat16"],
         raised="NotImplementedError")


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
    timed("build", phase_build)

    golden = json.loads(GOLDEN.read_text())
    check = timed("kernel_check", phase_kernel_check, torch, device)
    fa_check = timed("fa_check", phase_fa_check, torch, device)
    ssd_check = timed("ssd_check", phase_ssd_check, torch, device)
    timed("ssd_no_backward", phase_ssd_no_backward, torch, device)
    timed("cli", phase_cli, golden)
    timed("check", phase_check)
    full = timed("full", phase_full, torch, np, device, golden)
    # K1 is timed beside its own path, before the serving and training
    # phases, and its inputs are freed before them
    rows = [timed("time_lifetime_scan", time_lifetime_scan, torch, full,
                  check)]
    sys_session = full["session"]
    composes = [full["b7"]]
    del full
    # the systolic path's sweep beside its session (B7 held against its
    # plain version first, timed after), freed before the GPU-cache path
    b7_check = timed("compose_policy_check", phase_compose_policy_check,
                     torch, np, device)
    sweeps = [timed("sweep_systolic", phase_sweep, torch, np, device,
                    f"systolic@{FULL_LAYERS}", sys_session,
                    two_layer_systolic, cli=True)]
    b7_rows = timed("time_compose_policy", time_compose_policy, torch, np,
                    device, sys_session, b7_check)
    refs = [weakref.ref(x) for pair in sys_session._stats.values()
            for x in pair if x is not None]
    before = memo_state(torch)
    del sys_session
    check_session_freed(torch, refs, before)
    b6_check = timed("cache_replay_check", phase_cache_replay_check,
                     torch, np, device)
    gpu = timed("gpu", phase_gpu, torch, np, device)
    # B6 is timed beside its own path, the GPU-cache path's sweep runs on
    # its session; both are freed before serving
    b6_row = timed("time_cache_replay", time_cache_replay, torch, np,
                   device, gpu, b6_check)
    sweeps.append(timed("sweep_gpu", phase_sweep, torch, np, device,
                        f"gpu@{FULL_LAYERS}", gpu["session"],
                        two_layer_gpu))
    # every B7 kernel against its plain version at the other skew: the
    # wide grid on the GPU-cache session's largest subpartition
    skew = timed("b7_gpu_skew_check", b7_gpu_skew_check, torch, np,
                 device, gpu["session"])
    for row in b7_rows:
        row["gpu_skew_check"] = skew
    composes.append(gpu["b7"])
    del gpu
    torch.cuda.empty_cache()
    # the campaign phase, after the GPU-cache session is freed: its B6 and
    # B7 launches add to the rows' main-path counts
    campaign = timed("campaign", phase_campaign, torch, device)
    b6_row["launches"] += campaign["b6"]
    # the graph-walking backend on the models' own steps: B7 composes them
    composes += timed("tpu", phase_tpu, torch, np, device)
    for row in b7_rows:
        key = B7_LAUNCH_KEYS[row["name"]]
        row["launches"] = sum(run[key] for run in composes) + sum(
            sw["launches"][key] for sw in sweeps) + campaign["b7"][key]
    bwd_check = timed("bwd_check", phase_bwd_check, torch, device)
    timed("golden", phase_golden, torch, np, device)
    serve = timed("serve", phase_serve, torch, device)
    timed("train_golden", phase_train_golden, torch, np, device)
    train = timed("train", phase_train, torch, device)
    timed("family_golden", phase_family_golden, torch, np, device)
    families = timed("families", phase_families, torch, device)
    timed("tuned", phase_tuned, torch, np, device, smi)
    timed("mesh", phase_mesh, torch, np, device, smi)
    timed("dryrun", phase_dryrun, torch, device, smi)
    rows += timed("time_serving_kernels", time_serving_kernels, torch,
                  device, serve, fa_check, ssd_check)
    rows += timed("time_training_kernels", time_training_kernels, torch,
                  device, train, bwd_check, rows[1])
    timed("time_family_kernels", time_family_kernels, torch, device, rows,
          families)
    rows.append(b6_row)
    rows += b7_rows
    emit("walls", seconds={k: round(v, 3) for k, v in WALLS.items()},
         total_s=round(sum(WALLS.values()), 3))
    print(json.dumps({"kernels": rows}), flush=True)

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
