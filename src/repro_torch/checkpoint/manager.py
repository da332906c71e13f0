"""Checkpoint manager: atomic, restart-safe.

Layout (one directory per step):

  <root>/step_000123.tmp/...   -> renamed to step_000123/ when complete
      meta.json                   step, leaf key paths, dtypes, shapes
      leaf_00000.npy ...          one file per tensor leaf

The state is a tree of nested dicts whose leaves are tensors.  Leaves are
flattened in a fixed order, by their key paths (``"opt/m/layers.0.attn.wq"``,
dict keys sorted), and restore checks the paths against the like-state's.

Guarantees used by the fault-tolerance layer:
  - *atomicity*: the rename happens only after every leaf and the metadata
    are fsync'd; a crash mid-save leaves a .tmp dir that restore ignores
    and the next save removes.
  - *retention*: keep the latest ``keep`` complete checkpoints.
  - leaves are stored whole on the host; ``restore`` puts each back on the
    device of its like-state leaf, and onto the mesh: by ``shardings``
    (a tree of ``sharding.Sharding`` mirroring the state) or, where that
    gives none, by the like-leaf's own placements when it is a DTensor.
    Under a process group every rank gathers one DTensor leaf whole at a
    time, rank 0 alone writes it, and all drop it before the next.
bfloat16 leaves are stored as their int16 bit pattern (numpy has no
bfloat16) and viewed back, so the round trip is exact.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.distributed.sharding import distribute_local, full, is_dtensor

# numpy cannot hold these dtypes; store a same-width integer bit-view
_BIT_VIEWS = {torch.bfloat16: torch.int16}


def flatten(tree, prefix: str = "") -> list:
    """[(key path, leaf)] of a tree of nested dicts, keys sorted."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten(tree[k], f"{prefix}{k}/")
        return out
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"checkpoint leaf {prefix[:-1]!r} is "
                        f"{type(tree).__name__}, not a tensor")
    return [(prefix[:-1], tree)]


def unflatten(like, leaves: dict, prefix: str = ""):
    if isinstance(like, dict):
        return {k: unflatten(like[k], leaves, f"{prefix}{k}/")
                for k in like}
    return leaves[prefix[:-1]]


def _flat_shardings(tree, prefix: str = "") -> list:
    """[(key path, Sharding or None)] of a tree of nested dicts."""
    if tree is None or not isinstance(tree, dict):
        return [] if tree is None else [(prefix[:-1], tree)]
    out = []
    for k in sorted(tree):
        out += _flat_shardings(tree[k], f"{prefix}{k}/")
    return out


def _group():
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized() and \
        dist.get_world_size() > 1


def _writer() -> bool:
    return not _group() or torch.distributed.get_rank() == 0


def _barrier() -> None:
    if _group():
        torch.distributed.barrier()


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.all_steps()
        return s[-1] if s else None

    # ------------------------------------------------------------------
    def save(self, step: int, tree) -> str:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        writer = _writer()
        if writer:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        paths, dtypes, shapes = [], [], []
        # one leaf at a time: every rank gathers it whole (a collective, in
        # the same order on every rank), the writer stores it, all drop it
        for i, (path, x) in enumerate(flatten(tree)):
            paths.append(path)
            dtypes.append(str(x.dtype).removeprefix("torch."))
            shapes.append(list(x.shape))
            t = full(x.detach())
            if writer:
                if t.dtype in _BIT_VIEWS:
                    t = t.view(_BIT_VIEWS[t.dtype])
                with open(os.path.join(tmp, f"leaf_{i:05d}.npy"), "wb") as f:
                    np.save(f, t.cpu().numpy())
                    f.flush()
                    os.fsync(f.fileno())
            del t
        if writer:
            meta = {"step": step, "n_leaves": len(paths), "paths": paths,
                    "dtypes": dtypes, "shapes": shapes}
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()
        _barrier()
        return final

    def restore(self, like_tree, step: int | None = None, shardings=None):
        """(tree shaped like ``like_tree`` with the saved leaves, each on its
        like-leaf's device, step).  ``shardings``: a tree of
        ``Sharding`` (or None) leaves mirroring ``like_tree``, which puts
        each leaf onto its mesh placements; a DTensor like-leaf without
        one keeps its own."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self._step_dir(step)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        like = flatten(like_tree)
        paths = [p for p, _ in like]
        if paths != meta["paths"]:
            raise ValueError(
                f"checkpoint leaves {meta['paths'][:4]}... do not match the "
                f"state's {paths[:4]}... ({meta['n_leaves']} vs "
                f"{len(paths)} leaves)")
        placed = dict(_flat_shardings(shardings))
        out = {}
        for i, (path, ref) in enumerate(like):
            t = torch.from_numpy(np.load(os.path.join(d, f"leaf_{i:05d}.npy")))
            want = getattr(torch, meta["dtypes"][i])
            if want in _BIT_VIEWS:
                t = t.view(want)
            t = t.to(ref.device)
            target = placed.get(path)
            if target is not None:
                t = distribute_local(t, target.mesh, target.placements)
            elif is_dtensor(ref):
                t = distribute_local(t, ref.device_mesh, ref.placements)
            out[path] = t
        return unflatten(like_tree, out), meta["step"]

    # ------------------------------------------------------------------
    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        # drop stale tmp dirs (crashed saves)
        for d in os.listdir(self.root):
            if d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.root, d),
                              ignore_errors=True)
