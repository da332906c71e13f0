"""The port's mesh against the JAX reference over four ranks.

One module fixture runs the reference in a JAX subprocess on four virtual
host devices (``--xla_force_host_platform_device_count=4``, as
``tests/test_distributed.py`` does) on inputs made from a numpy seed, and
writes its inputs and outputs to ``tmp_path``; a second one runs the port
in four gloo ranks (``tests/torch_mesh_worker.py``: rendezvous through a
``FileStore`` under ``tmp_path``, ``torch.set_num_threads(1)`` per rank,
each rank destroys its group).  Both subprocesses run under a timeout in
a session of their own, killed whole on expiry.  The tests compare:

- ``pipeline_forward`` (4 stages, 6 microbatches) within 1e-6;
- ``compressed_psum`` within one quantization step (absmax / 127), bit
  equality recorded;
- the MoE expert-parallel dispatch (phi3.5-moe smoke, a (2, 2) mesh)
  within 1e-5 of the reference's, of the port's global path on each data
  shard (the same capacity) and, at capacity factor 8 (nothing dropped),
  of the port's global path on the whole batch; the global path on the
  mesh (each rank routes every token) within 1e-5 of it without a mesh;
- one (2, 2)-sharded float32 train step of TinyLlama, Mamba-2 and
  phi3.5-moe, loaded from the reference's parameters, against the
  reference's step: TinyLlama's and Mamba-2's single-device step,
  phi3.5-moe's on the reference's own (2, 2) mesh with
  ``moe_local_dispatch`` (its capacity is a data shard's, so it is no
  single-device computation).  Loss within 1e-5 relative, grad norm
  1e-4 relative, every updated parameter 1e-5; the parameters stay
  sharded by their templates;
- checkpoint restore onto the mesh (placements as templated, values
  bit-equal);
- serving of Mamba-2 and Zamba2 (smoke, float32) on the (2, 2) mesh:
  the caches placed as made, the tokens equal and the
  prefill logits within 1e-5 of the same port without a mesh;
- the data stream keyed by node, not rank: every rank of one host builds
  the reference's global batch.
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist

from repro.configs.base import ShapeCell
from repro.configs.base import get_config as jax_config
from repro.data import SyntheticLMDataset as JaxDataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 400

REFERENCE = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs.base import ShapeCell, get_config
from repro.data import SyntheticLMDataset, shard_batch
from repro.distributed import sharding
from repro.distributed.compat import make_mesh, shard_map
from repro.distributed.pipeline import pipeline_forward
from repro.launch.steps import make_optimizer, make_train_step
from repro.models import layers as L
from repro.models.api import batch_shardings, build
from repro.optim.compression import compressed_psum

out = {}
rng = np.random.default_rng(30)

def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = "/".join(str(p.key) for p in path)
        out[prefix + key] = np.asarray(leaf, np.float32)

S, M, mb, d = 4, 6, 2, 8
W = (rng.standard_normal((S, d, d)) * 0.3).astype(np.float32)
xs = rng.standard_normal((M, mb, d)).astype(np.float32)
out["pipe_W"], out["pipe_x"] = W, xs
out["pipe_ref"] = np.asarray(pipeline_forward(
    make_mesh((4,), ("stage",)), "stage", lambda p, x: jnp.tanh(x @ p),
    jnp.asarray(W), jnp.asarray(xs)))

x = (rng.standard_normal((4, 1000)) * np.array([[1.0], [0.5], [3.0], [0.1]])
     ).astype(np.float32)
out["psum_x"] = x
out["psum_ref"] = np.asarray(shard_map(
    lambda b: compressed_psum(b, "data"), mesh=make_mesh((4,), ("data",)),
    in_specs=P("data"), out_specs=P())(jnp.asarray(x)))

mesh = make_mesh((2, 2), ("data", "model"))
cfg = dataclasses.replace(get_config("phi3_5_moe", smoke=True),
                          moe_local_dispatch=True)
p, _ = L.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
flat(p, "moe_p/")
xm = rng.standard_normal((4, 8, cfg.d_model)).astype(np.float32)
out["moe_x"] = xm
sharding.set_mesh(mesh)
out["moe_ref"] = np.asarray(jax.jit(
    lambda p, x: L.moe_block(p, cfg, x)[0])(p, jnp.asarray(xm)))
sharding.set_mesh(None)

shape = ShapeCell("t", "train", 32, 4)
for arch in ("tinyllama_1_1b", "mamba2_130m", "phi3_5_moe"):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              param_dtype="float32",
                              moe_local_dispatch=arch == "phi3_5_moe")
    api = build(cfg)
    params, specs = api.init(jax.random.PRNGKey(0))
    flat(params, arch + "/p0:")
    opt = make_optimizer(cfg, total_steps=10)
    batch = SyntheticLMDataset(cfg, shape, seed=0).get_batch(0)
    if arch == "phi3_5_moe":
        sharding.set_mesh(mesh)
        params = jax.device_put(params, sharding.tree_shardings_for(
            jax.eval_shape(lambda p: p, params), specs))
        batch = shard_batch(batch, batch_shardings(cfg, shape))
    else:
        batch = shard_batch(batch, None)
    opt_state = opt.init(params)
    params, _, m = jax.jit(make_train_step(api, opt))(params, opt_state,
                                                      batch)
    sharding.set_mesh(None)
    out[arch + "/loss"] = np.float64(m["loss"])
    out[arch + "/grad_norm"] = np.float64(m["grad_norm"])
    flat(params, arch + "/p1:")
np.savez(sys.argv[1], **out)
"""


def _run(cmd, env):
    """Run ``cmd`` in a session of its own; on timeout kill the session
    (the spawned ranks too) and fail."""
    proc = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"{cmd[1]} timed out after {TIMEOUT} s")
    assert proc.returncode == 0, log[-4000:]


def _env(**kw):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src"),
         os.path.join(REPO, "tests", "_jax_compat")])
    env.pop("WORLD_SIZE", None)
    env.pop("LOCAL_WORLD_SIZE", None)
    env.update(kw)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    _run([sys.executable, "-c", REFERENCE, str(d / "ref.npz")],
         _env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
              JAX_PLATFORMS="cpu"))
    _run([sys.executable, os.path.join(REPO, "tests", "torch_mesh_worker.py"),
          str(d)], _env(OMP_NUM_THREADS="1"))
    assert not dist.is_initialized()
    return (dict(np.load(d / "ref.npz")), dict(np.load(d / "port.npz")),
            [dict(np.load(d / f"data_{r}.npz")) for r in range(4)])


def test_pipeline_forward_matches_reference(runs):
    ref, port, _ = runs
    np.testing.assert_allclose(port["pipeline"], ref["pipe_ref"], atol=1e-6,
                               rtol=0)
    seq = ref["pipe_x"]
    for w in ref["pipe_W"]:
        seq = np.tanh(seq @ w)
    np.testing.assert_allclose(port["pipeline"], seq, atol=1e-6, rtol=0)


def test_compressed_psum_matches_reference(runs):
    ref, port, _ = runs
    step = float(np.abs(ref["psum_x"]).max()) / 127.0
    got, want = port["psum"][0], ref["psum_ref"][0]
    # divergence, if any, is one rounding of x / scale at a .5 boundary
    assert np.abs(got - want).max() <= step * (1 + 1e-6)
    assert np.array_equal(got, want)
    np.testing.assert_allclose(got, ref["psum_x"].sum(0), atol=4 * step)


def test_moe_local_dispatch_matches_reference_and_global_path(runs):
    ref, port, _ = runs
    np.testing.assert_allclose(port["moe_local"], ref["moe_ref"], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(port["moe_local"],
                               port["moe_global_per_shard"], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(port["moe_local_cf8"], port["moe_global_cf8"],
                               atol=1e-5, rtol=0)


def test_moe_global_dispatch_on_the_mesh_matches_it_without(runs):
    _, port, _ = runs
    np.testing.assert_allclose(port["moe_global_mesh"], port["moe_global"],
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "mamba2_130m",
                                  "phi3_5_moe"])
def test_sharded_train_step_matches_reference(runs, arch):
    ref, port, _ = runs
    np.testing.assert_allclose(port[f"{arch}/loss"], ref[f"{arch}/loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(port[f"{arch}/grad_norm"],
                               ref[f"{arch}/grad_norm"], rtol=1e-4)
    assert port[f"{arch}/still_sharded"] == 1
    from repro_torch.convert import STACKED
    n = 0
    for key, got in port.items():
        if not key.startswith(f"{arch}/p1:"):
            continue
        parts = key.split(":", 1)[1].split(".")
        if parts[0] in STACKED:
            want = ref[f"{arch}/p1:" + "/".join([parts[0]] + parts[2:])][
                int(parts[1])]
        else:
            want = ref[f"{arch}/p1:" + "/".join(parts)]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                   err_msg=key)
        n += 1
    assert n >= 10


@pytest.mark.parametrize("arch", ["mamba2_130m", "zamba2_2_7b"])
def test_ssm_serving_on_the_mesh_gives_the_unsharded_tokens(runs, arch):
    """Prefill and seven greedy decode steps on the (2, 2) mesh, caches
    placed as their constructors make them (the decode specs' rule, the
    SSM state by batch only), against the same port without a mesh
    (float32)."""
    _, port, _ = runs
    assert port[f"{arch}/cache_placed"] == 1
    np.testing.assert_array_equal(port[f"{arch}/serve_tokens"],
                                  port[f"{arch}/serve_tokens_whole"])
    np.testing.assert_allclose(port[f"{arch}/serve_logits"],
                               port[f"{arch}/serve_logits_whole"],
                               atol=1e-5, rtol=0)


def test_checkpoint_restores_onto_the_mesh(runs):
    _, port, _ = runs
    assert port["ckpt_ok"] == 1


def test_every_rank_of_a_host_builds_the_reference_batch(runs, monkeypatch):
    _, _, data = runs
    cfg = jax_config("tinyllama_1_1b", smoke=True)
    shape = ShapeCell("t", "train", 32, 4)
    import repro.data.pipeline as ref_pipeline
    for node in (0, 1):
        monkeypatch.setattr(ref_pipeline.jax, "process_index",
                            lambda node=node: node)
        for step in (0, 3):
            want = JaxDataset(cfg, shape, seed=0).get_batch(step)
            for rank, got in enumerate(data):
                if node == 0:
                    pre = "node0"
                elif rank // 2 == 1:
                    pre = "node2x2"
                else:
                    continue
                for k in ("tokens", "labels"):
                    v = got[f"{pre}_step{step}_{k}"]
                    assert v.dtype == np.int64
                    np.testing.assert_array_equal(v, want[k])
    # the first node of the 2 x 2 split is node 0's stream
    for rank in (0, 1):
        np.testing.assert_array_equal(data[rank]["node2x2_step0_tokens"],
                                      data[rank]["node0_step0_tokens"])
