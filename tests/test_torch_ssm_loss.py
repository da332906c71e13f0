"""The training loss of the ``ssm`` (Mamba-2) and ``hybrid`` (Zamba2)
families against the JAX reference (CPU, smoke configs, float32), and the
SSD kernel route's missing backward.

The reference is initialised from ``PRNGKey(0)`` and its parameters are
loaded into the port (``repro_torch.convert.load_reference_params``);
tokens and labels are drawn with numpy from a seed.  Both train through
``attn_impl="ref"``: the reference's Pallas ``ssd_scan`` has no VJP, and
the port's kernel route raises on a backward on every device.

Tolerances, float32 (ROADMAP D10's 1e-4): the loss within 1e-4 relative;
every gradient leaf within 1e-4 of its max |value|; after one optimizer
step ``grad_norm`` within 1e-4 relative, ``lr`` within 1e-6 relative and
the parameters within 1e-4 abs + 1e-4 rel.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.launch.steps import make_optimizer as jax_make_optimizer
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import hybrid as jax_hybrid
from repro.models import mamba2 as jax_mamba
from repro.models.api import build as jax_build
from repro_torch.configs.base import get_config
from repro_torch.convert import export_params, load_reference_params
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch.steps import make_optimizer, make_train_step
from repro_torch.models.api import build

FAMILIES = {"mamba2_130m": jax_mamba, "zamba2_2_7b": jax_hybrid}
TOL = 1e-4


def to_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def assert_trees_close(got, want, what, atol=None, rtol=0.0, scaled=None):
    got, want = leaves(got), leaves(want)
    assert sorted(got) == sorted(want), what
    for k in want:
        assert got[k].shape == want[k].shape, f"{what} {k}"
        a = atol if scaled is None else \
            scaled * max(float(np.abs(want[k]).max()), 1e-30)
        np.testing.assert_allclose(got[k], want[k], atol=a, rtol=rtol,
                                   err_msg=f"{what} {k}")


def configs(arch, **kw):
    kw.setdefault("param_dtype", "float32")
    return (dataclasses.replace(jax_config(arch, smoke=True), **kw),
            dataclasses.replace(get_config(arch, smoke=True), **kw))


def numpy_batch(vocab, seed, shape=(2, 48)):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, shape),
            "labels": rng.integers(0, vocab, shape)}


def both(arch, seed=0, **kw):
    """(reference cfg, params, batch), (port api, batch) on one draw."""
    jcfg, tcfg = configs(arch, **kw)
    params, _ = FAMILIES[arch].init_lm(jax.random.PRNGKey(0), jcfg)
    api = build(tcfg, device="cpu")
    load_reference_params(api.model, to_numpy(params))
    nb = numpy_batch(jcfg.vocab, seed)
    jbatch = {k: jnp.asarray(v, jnp.int32) for k, v in nb.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
    return (jcfg, params, jbatch), (api, tbatch)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_loss_and_every_gradient_leaf_match_reference(arch):
    (jcfg, params, jbatch), (api, tbatch) = both(arch)
    loss_j, grads_j = jax.value_and_grad(FAMILIES[arch].loss_fn)(
        params, jcfg, jbatch)
    loss_t = api.loss(tbatch)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=TOL)
    grads_t = export_params({n: p.grad for n, p in
                             api.model.named_parameters()})
    assert_trees_close(grads_t, to_numpy(grads_j), "grad", scaled=TOL)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_one_train_step_matches_reference(arch):
    (jcfg, params, jbatch), (api, tbatch) = both(arch, seed=1)
    jopt = jax_make_optimizer(jcfg, total_steps=1)
    jstep = jax.jit(jax_make_train_step(jax_build(jcfg), jopt))
    jp, jstate, jm = jstep(params, jopt.init(params), jbatch)
    opt = make_optimizer(api.cfg, total_steps=1)
    step = make_train_step(api, opt)
    tp = dict(api.model.named_parameters())
    tp, state, m = step(tp, opt.init(tp), tbatch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=TOL)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=TOL)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    assert_trees_close(export_params(tp), to_numpy(jp), "params", atol=TOL,
                       rtol=TOL)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_remat_recomputes_the_same_loss_and_gradients(arch):
    """``cfg.remat`` wraps each Mamba-2 block in a checkpoint when grad is
    on: the values are the ones without it, exactly."""
    out = []
    for remat in (True, False):
        _, (api, tbatch) = both(arch, remat=remat)
        loss = api.loss(tbatch)
        loss.backward()
        out.append((loss.detach(), [p.grad.clone() for p in
                                    api.model.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    for g, w in zip(out[0][1], out[1][1], strict=True):
        assert torch.equal(g, w)


def ssd_inputs(requires_grad=True):
    g = torch.Generator().manual_seed(0)
    b, l, h, p, n = 1, 40, 2, 8, 4
    x = torch.randn(b, l, h, p, generator=g, requires_grad=requires_grad)
    dt = torch.rand(b, l, h, generator=g)
    A = -torch.rand(h, generator=g)
    B = torch.randn(b, l, n, generator=g)
    C = torch.randn(b, l, n, generator=g)
    return x, dt, A, B, C


def test_ssd_kernel_route_backward_raises_on_the_cpu():
    """F6: the route stands for the kernel, which has no backward; on the
    CPU its plain version runs, and the backward still raises.  The forward
    is the wrapper's, value for value."""
    x, dt, A, B, C = ssd_inputs()
    y = ssd_ops.ssd_scan(x, dt, A, B, C, chunk=16)
    assert y.grad_fn is not None
    with pytest.raises(NotImplementedError, match="no backward") as err:
        y.sum().backward()
    assert "attn_impl='ref'" in str(err.value)
    with torch.no_grad():
        want = ssd_kernel.ssd_scan_plain(
            torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 8)),
            torch.nn.functional.pad(dt, (0, 0, 0, 8)), A,
            torch.nn.functional.pad(B, (0, 0, 0, 8)),
            torch.nn.functional.pad(C, (0, 0, 0, 8)),
            torch.zeros(2), chunk=16)[:, :40]
    assert torch.equal(y.detach(), want)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_a_flash_training_step_raises_instead_of_dropping_the_gradient(arch):
    _, (api, tbatch) = both(arch, attn_impl="flash")
    loss = api.loss(tbatch)
    assert torch.isfinite(loss)
    with pytest.raises(NotImplementedError, match="no backward"):
        loss.backward()


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_train_launcher_trains_the_family(arch, tmp_path):
    from repro_torch.launch.train import main
    log = main(["--arch", arch, "--smoke", "--steps", "3", "--batch", "2",
                "--seq", "32", "--ckpt-dir", str(tmp_path)], device="cpu")
    assert len(log) == 3
    assert all(np.isfinite(m["loss"]) for m in log)
