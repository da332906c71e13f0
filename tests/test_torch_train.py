"""The port's training path (dense LM, AdamW, data, checkpoints, restart
supervision, launcher) against the JAX reference (CPU, TinyLlama smoke
config).

Parameters are the reference's (``PRNGKey(0)``), carried into the port by
``repro_torch.convert``; batches come from the data pipeline, whose tokens
are the reference's bit for bit.  With ``attn_impl="flash"`` the reference
runs its Pallas forward and backward kernels in interpret mode and the port
its kernels' plain versions through the autograd Function.

Tolerances, float32: the loss within 1e-5 relative; every gradient leaf
within 1e-4 of its max |value| (the two frameworks sum in other orders);
after three optimizer steps the parameters and master weights within 1e-5
abs + 1e-5 rel (AdamW normalises each element's step, so an element whose
gradient is near 0 in relative terms can move by a different fraction of
the learning rate, 3e-4 at its peak: 1e-5 is 1/30 of it), the moments
within 1e-4 of each leaf's max |value|,
``grad_norm`` within 1e-5 relative and ``lr`` within 1e-6 relative.
``cosine_schedule`` agrees within 1e-6 relative; the tokens agree
exactly.  Dense serving: logits within 1e-4 (float32) and 2e-2 (bfloat16);
the bf16 KV cache elementwise within 2e-2 for float32 weights and in
relative 2-norm within 5e-2 for bf16 weights, as
``tests/test_torch_models.py`` holds bf16 caches (ROADMAP D10).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.data import SyntheticLMDataset as JaxDataset
from repro.launch.steps import make_optimizer as jax_make_optimizer
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import transformer as jax_T
from repro.models.api import build as jax_build
from repro.optim import compress_gradients as jax_compress
from repro.optim import cosine_schedule as jax_cosine
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ShapeCell, get_config
from repro_torch.convert import (export_params, load_reference_params,
                                 tree_from_flat)
from repro_torch.data import SyntheticLMDataset, to_device
from repro_torch.launch.steps import (make_optimizer, make_prefill_step,
                                      make_serve_step, make_train_step)
from repro_torch.models import transformer as T
from repro_torch.models.api import build
from repro_torch.optim import AdamW, compress_gradients, cosine_schedule
from repro_torch.runtime import StragglerMonitor, TrainSupervisor

ARCH = "tinyllama_1_1b"
SHAPE = ShapeCell("t", "train", 64, 2)
GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "torch",
                      "golden_tinyllama_train_smoke.npz")


def configs(**kw):
    kw.setdefault("param_dtype", "float32")
    return (dataclasses.replace(jax_config(ARCH, smoke=True), **kw),
            dataclasses.replace(get_config(ARCH, smoke=True), **kw))


def to_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def leaves(tree, prefix=""):
    """{path: array} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def assert_trees_close(got, want, what, atol=None, rtol=0.0, scaled=None):
    """Leaf by leaf; ``scaled``: tolerance relative to the leaf's max."""
    got, want = leaves(got), leaves(want)
    assert sorted(got) == sorted(want), what
    for k in want:
        assert got[k].shape == want[k].shape, f"{what} {k}"
        a = atol if scaled is None else \
            scaled * max(float(np.abs(want[k]).max()), 1e-30)
        np.testing.assert_allclose(got[k], want[k], atol=a, rtol=rtol,
                                   err_msg=f"{what} {k}")


def port_model(tcfg, params):
    api = build(tcfg, device="cpu")
    load_reference_params(api.model, to_numpy(params))
    return api


@pytest.fixture(scope="module")
def ref_params():
    jcfg, _ = configs()
    params, _ = jax_T.init_lm(jax.random.PRNGKey(0), jcfg)
    return params


def jax_batch(i, seed=0):
    jcfg, _ = configs()
    return JaxDataset(jcfg, SHAPE, seed=seed).get_batch(i)


@pytest.mark.parametrize("impl", ["ref", "flash"])
def test_loss_and_every_gradient_leaf_match_reference(ref_params, impl):
    jcfg, tcfg = configs(attn_impl=impl)
    batch = jax_batch(0)
    loss_j, grads_j = jax.value_and_grad(jax_T.loss_fn)(ref_params, jcfg,
                                                        batch)
    api = port_model(tcfg, ref_params)
    loss_t = api.loss(to_device(batch, "cpu"))
    loss_t.backward()
    loss_t = loss_t.detach()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    grads_t = export_params({n: p.grad for n, p in
                             api.model.named_parameters()})
    assert_trees_close(grads_t, to_numpy(grads_j), "grad", scaled=1e-4)


def test_three_train_steps_match_reference(ref_params):
    jcfg, tcfg = configs(attn_impl="flash")
    jopt = jax_make_optimizer(jcfg, total_steps=3)
    jstep = jax.jit(jax_make_train_step(jax_build(jcfg), jopt))
    jstate = jopt.init(ref_params)
    api = port_model(tcfg, ref_params)
    opt = make_optimizer(tcfg, total_steps=3)
    step = make_train_step(api, opt)
    params = dict(api.model.named_parameters())
    state = opt.init(params)
    jp = ref_params
    for i in range(3):
        batch = jax_batch(i)
        jp, jstate, jm = jstep(jp, jstate, batch)
        params, state, m = step(params, state, to_device(batch, "cpu"))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 3
    assert_trees_close(export_params(params), to_numpy(jp), "params",
                       atol=1e-5, rtol=1e-5)
    assert_trees_close(export_params(state["master"]),
                       to_numpy(jstate["master"]), "master", atol=1e-5,
                       rtol=1e-5)
    for name in ("m", "v"):
        assert_trees_close(export_params(state[name]),
                           to_numpy(jstate[name]), name, scaled=1e-4)


def test_port_cpu_path_reproduces_the_train_golden_fixture():
    """The fixture the card is held to, on the CPU path: three steps from
    the reference's parameters on the reference's batches."""
    fx = dict(np.load(GOLDEN))
    _, tcfg = configs(attn_impl="flash")
    api = build(tcfg, device="cpu")
    load_reference_params(api.model, tree_from_flat(fx, "param:"))
    opt = make_optimizer(tcfg, total_steps=len(fx["loss"]))
    step = make_train_step(api, opt)
    params = dict(api.model.named_parameters())
    state = opt.init(params)
    for i in range(len(fx["loss"])):
        batch = {"tokens": torch.from_numpy(fx["tokens"][i]),
                 "labels": torch.from_numpy(fx["labels"][i])}
        params, state, m = step(params, state, batch)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), fx[k][i], rtol=1e-5)
        np.testing.assert_allclose(float(m["lr"]), fx["lr"][i], rtol=1e-6)
    assert_trees_close(export_params(params), tree_from_flat(fx, "final:"),
                       "final params", atol=1e-5, rtol=1e-5)


def test_data_pipeline_tokens_are_bit_identical():
    jcfg, tcfg = configs()
    for seed, step in ((0, 0), (3, 11), (7, 12345)):
        want = JaxDataset(jcfg, SHAPE, seed=seed).get_batch(step)
        got = SyntheticLMDataset(tcfg, SHAPE, seed=seed).get_batch(step)
        assert set(got) == {"tokens", "labels"}
        for k in ("tokens", "labels"):
            assert got[k].dtype == np.int64
            np.testing.assert_array_equal(got[k], want[k])
    d = SyntheticLMDataset(tcfg, SHAPE, seed=3)
    assert not np.array_equal(d.get_batch(11)["tokens"],
                              d.get_batch(12)["tokens"])
    batch = to_device(d.get_batch(0), "cpu")
    assert batch["tokens"].dtype == torch.int64
    assert tuple(batch["tokens"].shape) == (2, 64)


@pytest.mark.parametrize("args", [(3e-4, 10, 100), (1e-3, 1, 3),
                                  (3e-3, 3, 100, 0.0)])
def test_cosine_schedule_matches_reference(args):
    steps = np.arange(0, 120)
    want = np.asarray(jax.vmap(jax_cosine(*args))(jnp.asarray(steps)))
    got = cosine_schedule(*args)(torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_compress_gradients_matches_reference():
    rng = np.random.default_rng(0)
    g = {"a": rng.standard_normal((32, 32), dtype=np.float32),
         "b": rng.standard_normal((7,), dtype=np.float32) * 1e-3}
    e = {"a": rng.standard_normal((32, 32), dtype=np.float32) * 1e-3,
         "b": np.zeros(7, np.float32)}
    for err in (None, e):
        want_d, want_e = jax_compress(
            jax.tree.map(jnp.asarray, g),
            None if err is None else jax.tree.map(jnp.asarray, err))
        got_d, got_e = compress_gradients(
            {k: torch.from_numpy(v) for k, v in g.items()},
            None if err is None else
            {k: torch.from_numpy(v) for k, v in err.items()})
        for k in g:
            np.testing.assert_allclose(got_d[k].numpy(),
                                       np.asarray(want_d[k]), rtol=1e-6,
                                       atol=0)
            np.testing.assert_allclose(got_e[k].numpy(),
                                       np.asarray(want_e[k]), rtol=1e-5,
                                       atol=1e-7)
            # dequantized + error == original (+ incoming error)
            np.testing.assert_allclose(
                got_d[k].numpy() + got_e[k].numpy(),
                g[k] + (0 if err is None else err[k]), atol=1e-6)


def test_optimizer_state_structure():
    _, tcfg = configs(param_dtype="bfloat16")
    api = build(tcfg, device="cpu")
    params = dict(api.model.named_parameters())
    st = make_optimizer(tcfg).init(params)
    assert set(st) == {"step", "m", "v", "master"}
    for n, p in params.items():
        assert p.dtype == torch.bfloat16
        for k in ("m", "v", "master"):
            assert st[k][n].dtype == torch.float32
            assert st[k][n].shape == p.shape
        assert torch.equal(st["master"][n].to(p.dtype), p.detach())


def _small_state():
    _, tcfg = configs(param_dtype="bfloat16")
    api = build(tcfg, device="cpu")
    params = dict(api.model.named_parameters())
    return {"params": params, "opt": make_optimizer(tcfg).init(params)}


def test_checkpoint_roundtrip_bitexact_with_bf16_leaves(tmp_path):
    state = _small_state()
    state["opt"]["m"]["embed"].normal_()
    ck = CheckpointManager(str(tmp_path))
    ck.save(7, state)
    restored, s = ck.restore(state)
    assert s == 7
    want = dict(_flat(state))
    got = dict(_flat(restored))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k] is not want[k]
        assert torch.equal(got[k], want[k].detach()), k
    assert got["params/embed"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="do not match"):
        ck.restore({"x": torch.zeros(1)})


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def test_checkpoint_gc_and_tmp_cleanup(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep=2)
    small = {"x": torch.ones(4)}
    for s in (1, 2, 3, 4):
        ck.save(s, small)
    assert ck.all_steps() == [3, 4]
    # stale tmp dirs removed on next save; restore ignores them
    os.makedirs(os.path.join(str(tmp_path), "step_00000099.tmp"))
    assert ck.latest_step() == 4
    ck.save(5, small)
    assert not any(d.endswith(".tmp") for d in os.listdir(str(tmp_path)))
    assert ck.all_steps() == [4, 5]


def _replay_run(tmp_path, inject, tcfg, ref_params):
    api = port_model(tcfg, ref_params)
    opt = make_optimizer(tcfg, total_steps=100)
    step = make_train_step(api, opt)
    ds = SyntheticLMDataset(tcfg, SHAPE, seed=0)
    params = dict(api.model.named_parameters())
    state = {"params": params, "opt": opt.init(params)}
    ck = CheckpointManager(str(tmp_path / f"ck{inject}"))
    sup = TrainSupervisor(ck, save_every=3)
    fault = {"armed": inject}
    losses = []

    def one(state, i):
        if fault["armed"] and i == 4:
            fault["armed"] = False
            raise RuntimeError("boom")
        p, o, m = step(state["params"], state["opt"],
                       to_device(ds.get_batch(i), "cpu"))
        losses.append((i, float(m["loss"])))
        return {"params": p, "opt": o}

    state, end = sup.run(state, one, 6)
    return state, losses, sup


def test_restart_replay_is_deterministic(tmp_path, ref_params):
    """Crash + restore + replay reaches the same state as no crash, and the
    replayed steps' losses are bit-equal."""
    _, tcfg = configs()
    s_fault, l_fault, sup = _replay_run(tmp_path, True, tcfg, ref_params)
    s_clean, l_clean, _ = _replay_run(tmp_path, False, tcfg, ref_params)
    assert sup.restarts == 1
    assert [i for i, _ in l_fault] == [0, 1, 2, 3, 3, 4, 5]
    assert dict(l_fault) == dict(l_clean)
    for (k, a), (_, b) in zip(_flat(s_fault), _flat(s_clean)):
        assert torch.equal(a, b), k


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    sup = TrainSupervisor(ck, save_every=100, max_restarts=2)

    def always_fail(state, i):
        raise RuntimeError("dead host")

    with pytest.raises(RuntimeError, match="exceeded 2 restarts"):
        sup.run({"x": torch.zeros(1)}, always_fail, 10)
    assert sup.restarts == 3


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(threshold=2.0, patience=2)
    times = [1.0] * 10 + [5.0, 5.0] + [1.0] * 5
    flagged = [i for i, dt in enumerate(times) if mon.observe(i, dt)]
    assert flagged == [11]


@pytest.mark.parametrize("compress", [False, True])
def test_loss_decreases_over_training(ref_params, compress):
    _, tcfg = configs()
    api = port_model(tcfg, ref_params)
    opt = AdamW(lr=cosine_schedule(3e-3, 3, 100))
    step = make_train_step(api, opt, compress_grads=compress)
    ds = SyntheticLMDataset(tcfg, SHAPE, seed=0)
    params = dict(api.model.named_parameters())
    state = opt.init(params)
    losses = []
    for i in range(30 if not compress else 20):
        params, state, m = step(params, state,
                                to_device(ds.get_batch(i), "cpu"))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    if compress:
        assert set(state["grad_err"]) == set(params)
        assert np.mean(losses[-4:]) < np.mean(losses[:4])
    else:
        assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_prefill_and_decode_match_reference(ref_params, dtype):
    jcfg, tcfg = configs(param_dtype=dtype)
    params = jax.tree.map(lambda a: a.astype(getattr(jnp, dtype)),
                          ref_params)
    api = port_model(tcfg, params)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 40))
    j_logits, j_cache = jax.jit(jax_T.prefill, static_argnums=1)(
        params, jcfg, jnp.asarray(tokens, jnp.int32))
    t_logits, t_cache = make_prefill_step(api)(
        {"tokens": torch.from_numpy(tokens)})
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(t_logits.float().numpy(),
                               np.asarray(j_logits, np.float32), atol=tol,
                               rtol=tol)
    tok = np.asarray(jnp.argmax(j_logits, -1))
    j_logits2, j_cache2 = jax.jit(jax_T.decode_step, static_argnums=1)(
        params, jcfg, j_cache, jnp.asarray(tok, jnp.int32), jnp.int32(33))
    t_logits2, t_cache2 = make_serve_step(api)(
        t_cache, torch.tensor(tok).long(), 33)
    np.testing.assert_allclose(t_logits2.float().numpy(),
                               np.asarray(j_logits2, np.float32), atol=tol,
                               rtol=tol)
    for j, t in zip(j_cache2["main"], t_cache2["main"]):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == j.shape
        got, want = t.float().numpy(), np.asarray(j, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)
        else:   # as tests/test_torch_models.py holds bf16 caches (D10)
            assert np.linalg.norm(got - want) <= \
                5e-2 * np.linalg.norm(want)


def test_export_params_inverts_load_reference_params(ref_params):
    _, tcfg = configs()
    api = port_model(tcfg, ref_params)
    tree = export_params(api.model)
    assert_trees_close(tree, to_numpy(ref_params), "export", atol=0)
    assert tree["layers"]["attn"]["wq"].shape == (2, 64, 64)
    bad = export_params(api.model)
    del bad["layers"]["mlp"]["w_up"]
    with pytest.raises(KeyError):
        load_reference_params(api.model, bad)


def test_remat_gives_the_same_gradients_as_no_remat(ref_params):
    _, tcfg = configs(attn_impl="flash")
    batch = to_device(jax_batch(0), "cpu")
    grads = []
    for remat in (True, False):
        api = port_model(dataclasses.replace(tcfg, remat=remat), ref_params)
        api.loss(batch).backward()
        grads.append([p.grad for p in api.model.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_train_main_runs_with_fault_and_writes_metrics(tmp_path, capsys):
    from repro_torch.launch.train import main
    log = main(["--arch", ARCH, "--smoke", "--steps", "12", "--batch", "2",
                "--seq", "32", "--ckpt-dir", str(tmp_path), "--save-every",
                "5", "--inject-fault-at", "7", "--compress-grads"],
               device="cpu")
    out = capsys.readouterr().out
    assert "restarts=1" in out and "step     0 loss=" in out
    assert [m["step"] for m in log] == list(range(7)) + list(range(5, 12))
    assert json.loads((tmp_path / "metrics.json").read_text()) == log
    assert all(np.isfinite(m["loss"]) for m in log)
    # --mesh host on a world of one: a (1, 1) mesh of DTensors gives the
    # same losses, and the process group main made is gone afterwards
    import torch.distributed as dist
    argv = ["--arch", ARCH, "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "32", "--save-every", "100"]
    plain = main(argv + ["--ckpt-dir", str(tmp_path / "none")],
                 device="cpu")
    meshed = main(argv + ["--ckpt-dir", str(tmp_path / "host"), "--mesh",
                          "host"], device="cpu")
    assert not dist.is_initialized()
    for a, b in zip(plain, meshed, strict=True):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-6, atol=0)
    for kind in ("single", "multi"):
        with pytest.raises(RuntimeError, match="needs (256|512) processes"):
            main(argv + ["--ckpt-dir", str(tmp_path / kind), "--mesh", kind],
                 device="cpu")
        assert not dist.is_initialized()


def test_training_entry_points_default_to_the_card(monkeypatch):
    from repro_torch.launch.train import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        build(get_config(ARCH, smoke=True))


def test_losses_of_unported_families_raise():
    # every family trains since the MoE, VLM and audio families were ported
    # (tests/test_torch_moe.py, tests/test_torch_vlm_audio.py): the cases
    # that raised naming A9 now build and give a finite loss and gradients
    batch = to_device(jax_batch(0), "cpu")
    moe = dataclasses.replace(get_config(ARCH, smoke=True), family="moe")
    api = build(moe, device="cpu")
    assert isinstance(api.model, T.TransformerLM)
    assert torch.isfinite(api.loss(batch))
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), moe_experts=4,
                              moe_topk=2)
    model = T.TransformerLM(cfg, "cpu", torch.Generator().manual_seed(0))
    loss = T.loss_fn(model, batch)
    loss.backward()
    assert torch.isfinite(loss)
    assert model.layers[0].moe.router.grad is not None
    assert model.layers[0].moe.router.dtype == torch.float32
