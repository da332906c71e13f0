"""The port's multi-rank runs for ``tests/test_torch_distributed.py``.

    python tests/torch_mesh_worker.py OUT_DIR

spawns four CPU ranks (gloo, rendezvous through a ``FileStore`` in
OUT_DIR, one thread each) that read the reference's inputs and parameters
from ``OUT_DIR/ref.npz`` and write what they compute to
``OUT_DIR/port.npz`` (rank 0) and ``OUT_DIR/data_<rank>.npz``; the
SSM families' serving on the mesh is held against their serving without
it, both computed here.  Imports
torch and the port only.  Every rank destroys its process group before it
exits.
"""

import dataclasses
import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
ARCHS = ("tinyllama_1_1b", "mamba2_130m", "phi3_5_moe")
SERVE_ARCHS = ("mamba2_130m", "zamba2_2_7b")
TRAIN_SHAPE = (32, 4)           # seq, global batch


def _tree(flat, prefix):
    from repro_torch.convert import tree_from_flat
    return tree_from_flat(flat, prefix=prefix)


def _cfg(arch):
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(arch, smoke=True),
                               param_dtype="float32",
                               moe_local_dispatch=arch == "phi3_5_moe")


def _data(rank, out_dir):
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import SyntheticLMDataset
    shape = ShapeCell("t", "train", *TRAIN_SHAPE)
    ds = SyntheticLMDataset(_cfg("tinyllama_1_1b"), shape, seed=0)
    got = {f"node0_step{s}_{k}": v for s in (0, 3)
           for k, v in ds.get_batch(s).items()}
    os.environ["LOCAL_WORLD_SIZE"] = "2"       # two nodes of two ranks
    try:
        got.update({f"node2x2_step{s}_{k}": v for s in (0, 3)
                    for k, v in ds.get_batch(s).items()})
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    np.savez(os.path.join(out_dir, f"data_{rank}.npz"), **got)


def _pipeline(ref, out):
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.distributed.pipeline import pipeline_forward
    mesh = make_mesh((WORLD,), ("stage",), "cpu")
    W = torch.from_numpy(ref["pipe_W"])
    xs = torch.from_numpy(ref["pipe_x"])
    out["pipeline"] = pipeline_forward(
        mesh, "stage", lambda p, x: torch.tanh(x @ p), W, xs).numpy()


def _psum(rank, ref, out):
    from repro_torch.optim import compressed_psum
    x = torch.from_numpy(ref["psum_x"][rank:rank + 1])
    out["psum"] = compressed_psum(x, dist.group.WORLD).numpy()


@torch.no_grad()
def _moe(rank, ref, out, mesh):
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import layers as L
    from repro_torch.models.api import param_templates, ModelApi
    cfg = _cfg("phi3_5_moe")
    moe = L.MoE(cfg, torch.float32, "cpu",
                torch.Generator().manual_seed(0))
    for name, p in moe.named_parameters():
        p.data.copy_(torch.from_numpy(ref["moe_p/" + name.replace(".", "/")]))
    x = torch.from_numpy(ref["moe_x"])
    B = x.shape[0]
    shd.set_mesh(None)
    glob = {cf: L.moe_block(moe, cfg, x, cf)[0] for cf in (1.25, 8.0)}
    # the global path on each data shard's tokens alone: the local
    # dispatch's capacity is its shard's
    shard = torch.cat([L.moe_block(moe, cfg, x[i:i + B // 2], 1.25)[0]
                       for i in (0, B // 2)])
    shd.set_mesh(mesh)
    try:
        api = ModelApi(cfg, moe, None, None, None)
        tpl = param_templates(api)
        for name, p in list(moe.named_parameters()):
            moe._parameters[name] = torch.nn.Parameter(
                shd.place(p.detach(), tpl[name]))
        xd = shd.place(x, ("BATCH", None, None))
        with shd.context():
            local = {cf: L.moe_block(moe, cfg, xd, cf)[0].full_tensor()
                     for cf in (1.25, 8.0)}
            # the global path on the mesh: every rank routes all tokens
            glob_mesh = L.moe_block(
                moe, dataclasses.replace(cfg, moe_local_dispatch=False), xd,
                1.25)[0].full_tensor()
    finally:
        shd.set_mesh(None)
    out["moe_local"] = local[1.25].numpy()
    out["moe_local_cf8"] = local[8.0].numpy()
    out["moe_global_cf8"] = glob[8.0].detach().numpy()
    out["moe_global_per_shard"] = shard.detach().numpy()
    out["moe_global"] = glob[1.25].detach().numpy()
    out["moe_global_mesh"] = glob_mesh.numpy()


def _train(ref, out, mesh, ckpt_dir):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import ShapeCell
    from repro_torch.convert import load_reference_params
    from repro_torch.data import SyntheticLMDataset, shard_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.sharding import full
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.models.api import build, shard_params
    shape = ShapeCell("t", "train", *TRAIN_SHAPE)
    shd.set_mesh(mesh)
    try:
        for arch in ARCHS:
            cfg = _cfg(arch)
            api = build(cfg, device="cpu")
            load_reference_params(api.model, _tree(ref, f"{arch}/p0:"))
            templates = shard_params(api)
            params = dict(api.model.named_parameters())
            opt = make_optimizer(cfg, total_steps=10)
            opt_state = opt.init(params)
            step = make_train_step(api, opt)
            batch = shard_batch(
                SyntheticLMDataset(cfg, shape, seed=0).get_batch(0),
                api.batch_shardings(shape), "cpu")
            params, opt_state, m = step(params, opt_state, batch)
            out[f"{arch}/loss"] = np.float64(full(m["loss"]))
            out[f"{arch}/grad_norm"] = np.float64(full(m["grad_norm"]))
            placed = all(
                tuple(p.placements) == shd.fitted_sharding(
                    p.shape, templates[n]).placements
                for n, p in params.items())
            sharded = sum(any(pl != shd.Replicate() for pl in p.placements)
                          for p in params.values())
            out[f"{arch}/still_sharded"] = np.int64(placed and sharded > 0)
            for n, p in params.items():
                out[f"{arch}/p1:{n}"] = full(p).detach().numpy()
            if arch == "tinyllama_1_1b":
                _checkpoint(params, templates, out, ckpt_dir)
    finally:
        shd.set_mesh(None)


def _checkpoint(params, templates, out, ckpt_dir):
    """Save the sharded parameters, restore them onto the mesh by their
    templates (from a like-tree of whole tensors) and by the like-tree's
    own placements."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.sharding import full
    ck = CheckpointManager(ckpt_dir)
    ck.save(1, {"params": params})
    whole = {n: full(p).detach().clone() for n, p in params.items()}
    shardings = {"params": shd.tree_shardings_for(
        whole, {n: templates[n] for n in whole})}
    got, step = ck.restore({"params": whole}, shardings=shardings)
    kept, _ = ck.restore({"params": params})
    ok = step == 1
    for n, p in params.items():
        for tree in (got, kept):
            r = tree["params"][n]
            ok &= tuple(r.placements) == tuple(p.placements)
            ok &= bool(torch.equal(full(r), whole[n]))
    out["ckpt_ok"] = np.int64(ok)


@torch.no_grad()
def _serve(out, mesh):
    """Prefill and greedy decode of the SSM families' smoke configs
    (float32) on the mesh and without it; the caches' placements as their
    constructors make them."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import shard_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.serve import generate
    from repro_torch.models import hybrid, mamba2
    from repro_torch.models.api import build, shard_params
    shape = ShapeCell("s", "prefill", 24, 4)
    for arch in SERVE_ARCHS:
        cfg = _cfg(arch)
        api = build(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
        batch = api.make_batch(torch.Generator().manual_seed(1), shape)
        whole = generate(api, batch, 16, 8)
        shd.set_mesh(mesh)
        try:
            shard_params(api)
            sharded = shard_batch(batch, api.batch_shardings(shape), "cpu")
            with shd.context():
                got = generate(api, sharded, 16, 8)
                cache = (hybrid.init_cache(cfg, 4, 24, "cpu")
                         if cfg.family == "hybrid" else
                         mamba2.init_ssm_cache(cfg, cfg.n_layers, 4, "cpu"))
            placed = all(
                tuple(v.placements) == shd.fitted_sharding(
                    v.shape, mamba2.SSM_STATE_TEMPLATE if k == "ssm"
                    else shd.cache_template(v.dim())).placements
                for k, v in cache.items())
        finally:
            shd.set_mesh(None)
        out[f"{arch}/serve_tokens"] = got.tokens.numpy()
        out[f"{arch}/serve_tokens_whole"] = whole.tokens.numpy()
        out[f"{arch}/serve_logits"] = got.prefill_logits.float().numpy()
        out[f"{arch}/serve_logits_whole"] = \
            whole.prefill_logits.float().numpy()
        out[f"{arch}/cache_placed"] = np.int64(placed)


def _rank(rank, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), WORLD),
        rank=rank, world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    try:
        from repro_torch.distributed.compat import make_mesh
        ref = dict(np.load(os.path.join(out_dir, "ref.npz")))
        out = {}
        _data(rank, out_dir)
        _pipeline(ref, out)
        _psum(rank, ref, out)
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        _moe(rank, ref, out, mesh)
        _train(ref, out, mesh, os.path.join(out_dir, "ckpt"))
        _serve(out, mesh)
        if rank == 0:
            np.savez(os.path.join(out_dir, "port.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    import warnings
    warnings.filterwarnings("ignore")
    mp.spawn(_rank, args=(sys.argv[1],), nprocs=WORLD, join=True)
