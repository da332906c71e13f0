"""End-to-end training launcher.

Runs real optimization steps with checkpoint/restart supervision,
straggler monitoring, deterministic data, and optional fault injection.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama_1_1b \
      --smoke --steps 60 --batch 8 --seq 128

Runs on the CUDA device (and raises without one); a caller may pass
``main(argv, device="cpu")``, as the tests do.  The flash-attention
kernels run when the config asks for them (``attn_impl="flash"``), as in
the reference; the CLI trains the config as published, and a caller may
pass ``main(argv, attn_impl="flash")``.

``--mesh host|single|multi`` trains over a ``DeviceMesh``: parameters,
optimizer state and batches are DTensors placed by their logical
templates.  A torch mesh needs a process group: ``main`` makes one for a
world of one (``--mesh host`` on one card), or joins ``torchrun``'s
(``torchrun --nproc-per-node N -m repro_torch.launch.train --mesh
host``), and destroys a group it made before it returns.  ``single`` and
``multi`` are the production meshes and raise on a world that is not 256
or 512 processes.  The default is ``none``, unlike the reference's
``host``: a library call should not make a process group unasked.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ShapeCell, get_config
from repro_torch.data import SyntheticLMDataset, shard_batch
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import full
from repro_torch.launch.mesh import set_up_mesh, tear_down_mesh
from repro_torch.launch.steps import make_optimizer, make_train_step
from repro_torch.models.api import build, shard_params
from repro_torch.optim import compress_gradients
from repro_torch.runtime import TrainSupervisor


def main(argv=None, *, device=None, attn_impl=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama_1_1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--mesh", default="none",
                    choices=["none", "host", "single", "multi"])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--inject-fault-at", type=int, default=-1,
                    help="raise at this step once (fault-tolerance demo)")
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    device = resolve_device(device)
    try:
        set_up_mesh(args.mesh, device)
        return _train(args, device, attn_impl)
    finally:
        tear_down_mesh()


def _is_writer() -> bool:
    dist = torch.distributed
    return not dist.is_initialized() or dist.get_rank() == 0


def _train(args, device, attn_impl):
    cfg = get_config(args.arch, smoke=args.smoke)
    if attn_impl is not None:
        cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    shape = ShapeCell("train", "train", args.seq, args.batch)
    api = build(cfg, device=device,
                generator=torch.Generator(device=device).manual_seed(0))
    shard_params(api)
    ds = SyntheticLMDataset(cfg, shape, seed=0)
    opt = make_optimizer(cfg, total_steps=args.steps)
    train_step = make_train_step(api, opt,
                                 compress_grads=args.compress_grads)

    params = dict(api.model.named_parameters())
    opt_state = opt.init(params)
    if args.compress_grads:
        _, err0 = compress_gradients(
            {n: torch.zeros_like(p) for n, p in params.items()}, None)
        opt_state["grad_err"] = err0
    state = {"params": params, "opt": opt_state}

    ckpt = CheckpointManager(args.ckpt_dir)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        state, start = ckpt.restore(state)
        print(f"resumed from step {start}")

    sup = TrainSupervisor(ckpt, save_every=args.save_every)
    metrics_log = []
    faulted = {"done": False}

    def one_step(state, step):
        if step == args.inject_fault_at and not faulted["done"]:
            faulted["done"] = True
            raise RuntimeError("injected fault (host died)")
        batch = shard_batch(ds.get_batch(step), api.batch_shardings(shape),
                            device)
        params, opt_state, m = train_step(state["params"], state["opt"],
                                          batch)
        m = {k: float(full(v)) for k, v in m.items()}
        metrics_log.append({"step": step, **m})
        if step % 10 == 0:
            print(f"step {step:5d} loss={m['loss']:.4f} "
                  f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e}")
        return {"params": params, "opt": opt_state}

    t0 = time.time()
    state, end = sup.run(state, one_step, args.steps, start_step=start)
    dt = time.time() - t0
    n_run = len(metrics_log)
    print(f"done: {end} steps in {dt:.1f}s "
          f"({dt / max(n_run, 1):.3f}s/step), restarts={sup.restarts}, "
          f"straggler_flags={len(sup.straggler.flagged)}")
    if metrics_log:
        first, last = metrics_log[0]["loss"], metrics_log[-1]["loss"]
        print(f"loss {first:.4f} -> {last:.4f}")
    if _is_writer():
        with open(os.path.join(args.ckpt_dir, "metrics.json"), "w") as f:
            json.dump(metrics_log, f)
    return metrics_log


if __name__ == "__main__":
    main()
