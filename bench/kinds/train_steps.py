"""Closed-loop training through the program's ``launch/steps.py``
``make_train_step``: one optimizer step after another, each on its own
batch of token sequences.

The mix's parameters (``traffic/<mix>.json``):

- ``batch``, ``seq``: sequences a step and their length;
- ``pool_steps``: batches drawn in set-up (the window may not need more);
- ``zipf``, ``follow``: the token stream, a frozen copy of the program's
  synthetic data (``data/pipeline.py``): Zipf(``zipf``) ids modulo the
  vocabulary, each next id replaced by (7 * id + 13) mod V with
  probability ``follow``;
- ``trace_steps``: steps run under the device timeline in a ``--trace 1``
  run.

Set-up builds one training step with its model and optimizer state (the
launcher's ``make_optimizer``), with the weights of
``reference/weights.py``, and drives it through its first three steps on
batches 0-2 of the pool, through the same call and feed as the window.
They record what the check compares: each step's loss, each leaf's
gradient as the optimizer took it in step 1 (its first moment over
1 - b1) and each leaf's change after step 3 (the optimizer's float32
master weights against the initial weights).  The window then steps on
from batch 3.  The check runs the float32 reference's three steps from the
same weights and batches, its forward on its float32 master weights
rounded to bf16 as the program's model stores them.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from bench.harness import device_sync, now
from bench.program import load_program, program_config, reference_module
from bench.reference import weights as W

DATA_STREAM = 5
FIRST_STEPS = 3


def batches(traffic: dict, vocab: int, seed: int, n: int) -> list:
    """{"tokens", "labels"} int64 [batch, seq] of ``n`` steps, every row
    its own draw."""
    rng = np.random.default_rng([int(seed) % 2 ** 63, DATA_STREAM])
    B, S = int(traffic["batch"]), int(traffic["seq"])
    out = []
    for _ in range(n):
        base = rng.zipf(float(traffic["zipf"]), size=(B, S + 1)) % vocab
        follow = rng.random((B, S)) < float(traffic["follow"])
        toks = base.copy()
        toks[:, 1:] = np.where(follow, (7 * toks[:, :-1] + 13) % vocab,
                               toks[:, 1:])
        out.append({"tokens": toks[:, :-1].astype(np.int64),
                    "labels": toks[:, 1:].astype(np.int64)})
    return out


def stored_as(master, dtype):
    """``master`` as the model stores it (rounded to ``dtype``), in
    float32; the gradient passes to the master weight unchanged."""
    if dtype == torch.float32:
        return master
    return master + (master.to(dtype).float() - master).detach()


def leaf_norms(tensors: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.float())) for n, t in
            tensors.items()}


class Driver:
    """Set-up, window, traced sub-window and check of one training run.
    ``wrap`` (None, or step -> step) wraps the program's step: the faults
    of ``bench/faults.py`` are planted there."""

    def __init__(self, run):
        self.run = run
        self.t = run.traffic
        self.wrap = None

    def setup(self):
        from repro_torch.launch.steps import make_optimizer, make_train_step
        run, dev = self.run, self.run.device
        m = run.cfg["model"]
        self.ref = reference_module(run.cfg)
        self.specs = self.ref.specs(m)
        self.api = load_program(run.cfg, W.make_weights(self.specs, run.seed,
                                                        dev),
                                dev, trainable=True)
        self.optimizer = make_optimizer(program_config(run.cfg))
        self.live = dict(self.api.model.named_parameters())
        self.state = self.optimizer.init(self.live)
        step = make_train_step(self.api, self.optimizer)
        self.step = step if self.wrap is None else self.wrap(step)
        pool = batches(self.t, m["vocab"], run.seed, int(self.t["pool_steps"]))
        self.pool = [{k: torch.as_tensor(v).to(dev) for k, v in b.items()}
                     for b in pool]
        self.first = {"loss": []}
        for i in range(FIRST_STEPS):
            metrics = self._step(i)
            self.first["loss"].append(float(metrics["loss"]))
            if i == 0:
                b1 = self.optimizer.b1
                self.first["grad"] = leaf_norms(
                    {n: m_ / (1 - b1) for n, m_ in self.state["m"].items()})
        self.first["change"] = self._change_norms()
        device_sync(dev)

    def _step(self, i: int):
        _, self.state, metrics = self.step(self.live, self.state, self.pool[i])
        return metrics

    def _change_norms(self) -> dict:
        """Each leaf's change so far: the optimizer's master weights
        against the initial weights, drawn again from the seed."""
        w0 = W.make_weights(self.specs, self.run.seed, self.run.device)
        out = {n: float(torch.linalg.vector_norm(
            self.state["master"][n] - w0[n].float())) for n in w0}
        del w0
        return out

    def window(self):
        run = self.run
        t_start = now()
        i = FIRST_STEPS
        B, S = int(self.t["batch"]), int(self.t["seq"])
        while now() - t_start < run.seconds:
            if i >= len(self.pool):
                raise RuntimeError("the window outran the pool of batches: "
                                   "raise pool_steps in the mix")
            self._step(i)
            run.records.append({"step": i, "rows": B, "tokens": B * S})
            i += 1
        device_sync(run.device)
        run.window_s = now() - t_start
        return i

    def wrappers(self) -> dict:
        """The hand-written kernels' wrappers the timeline brackets, at
        the names their callers look them up by."""
        from repro_torch.kernels.flash_attention import ops as fa_ops
        return {(fa_ops, "flash_attention_bhsd"): "K2 flash_attention_bhsd",
                (fa_ops, "flash_attention_bwd_bhsd"):
                    "K3+K4 flash_attention_bwd_bhsd"}

    def traced(self, timeline, first: int):
        """``trace_steps`` steps from the pool's ``first`` under
        ``timeline`` (``bench/timeline.py``), each in a span of its own;
        the program's kernel counters over them, and how much longer a
        step took than the window's."""
        from repro_torch.kernels.flash_attention import kernel as fa_k
        from repro_torch.kernels.flash_attention import kernel_bwd as bwd_k
        n = int(self.t["trace_steps"])
        if first + n > len(self.pool):
            raise RuntimeError("no batches left for the traced steps")
        counters = (fa_k.flash_attention_bhsd, bwd_k.flash_attention_bwd_dq,
                    bwd_k.flash_attention_bwd_dkv)
        c0 = [c.launches for c in counters]
        device_sync(self.run.device)
        with timeline:
            t0 = now()
            for i in range(first, first + n):
                with timeline.unit("train step"):
                    self._step(i)
            device_sync(self.run.device)
            wall = now() - t0
        calls = [c.launches - c0_ for c, c0_ in zip(counters, c0)]
        per_step = self.run.window_s / len(self.run.records)
        self.run.counts = {"k2_calls": calls[0], "k3_calls": calls[1],
                           "k4_calls": calls[2], "steps": n,
                           "batch": int(self.t["batch"]),
                           "seq": int(self.t["seq"]),
                           "slowdown": wall / n / per_step - 1}

    def free(self):
        del self.api, self.live, self.state, self.step, self.optimizer
        gc.collect()
        if torch.device(self.run.device).type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------
    def reference_readings(self, precision="float32") -> dict:
        """The reference's three steps from the same weights and batches:
        losses, step 1's gradients as the update took them, the changes
        after step 3 (norms per leaf).  Its float32 master weights carry
        the update, and each forward takes them rounded to the dtype the
        configuration stores each parameter in, as the program's model
        holds them."""
        from bench.reference.plain import strict_float32
        run = self.run
        m = run.cfg["model"]
        w = W.make_weights(self.specs, run.seed, run.device,
                           dtype_override=torch.float32)
        stored = {name: dtype for name, _, dtype, _ in self.specs}
        opt = self.ref.AdamW(w)
        out = {"loss": []}
        with strict_float32():
            for i in range(FIRST_STEPS):
                leaves = {n: t.requires_grad_() for n, t in w.items()}
                b = self.pool[i]
                loss = self.ref.loss(
                    {n: stored_as(t, stored[n]) for n, t in leaves.items()},
                    m, b["tokens"], b["labels"], precision)
                grads = torch.autograd.grad(loss, list(leaves.values()))
                for t in leaves.values():
                    t.requires_grad_(False)
                out["loss"].append(float(loss.detach()))
                taken = opt.update(w, dict(zip(leaves, grads)))
                del grads
                if i == 0:
                    out["grad"] = leaf_norms(taken)
                del taken
        del opt
        w0 = W.make_weights(self.specs, run.seed, run.device)
        out["change"] = {n: float(torch.linalg.vector_norm(
            w[n] - w0[n].float())) for n in w}
        del w, w0
        return out

    def check(self) -> dict:
        self.ref_readings = self.reference_readings()
        return compare(self.first, self.ref_readings, self.run.limits)

    def control(self) -> dict:
        """The control's readings against the check's reference: the
        reference in fp8 put in the program's place."""
        gc.collect()
        if torch.device(self.run.device).type == "cuda":
            torch.cuda.empty_cache()
        low = self.reference_readings(precision="fp8")
        return {k: v["value"] for k, v in
                compare(low, self.ref_readings,
                        {k: 0.0 for k in LIMIT_NAMES}).items()}


LIMIT_NAMES = ("loss_rel_gap_max", "grad_norm_gap_max", "change_norm_gap_max")
# a leaf whose reference gradient is under this share of the median leaf's
# moves under AdamW by round-off alone (a key projection's bias under
# softmax): its change is left out
QUIET_LEAF = 1e-3


def _norm_gap(prog: dict, ref: dict, names) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of that leaf's reference norm and the
    median leaf's."""
    median = float(np.median([ref[n] for n in names]))
    return max(abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30)
               for n in names)


def compare(prog: dict, ref: dict, limits: dict) -> dict:
    losses = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                      ref["loss"]))
    names = sorted(ref["grad"])
    median_grad = float(np.median([ref["grad"][n] for n in names]))
    moving = [n for n in names if ref["grad"][n] >= QUIET_LEAF * median_grad]
    values = {"loss_rel_gap_max": losses,
              "grad_norm_gap_max": _norm_gap(prog["grad"], ref["grad"], names),
              "change_norm_gap_max": _norm_gap(prog["change"], ref["change"],
                                               moving)}
    return {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
