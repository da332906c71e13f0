"""Shared helpers of the MoE, VLM and audio family tests
(``tests/test_torch_moe.py``, ``tests/test_torch_vlm_audio.py``): the JAX
reference initialised from ``PRNGKey(0)`` and loaded into the port
(``repro_torch.convert.load_reference_params``), batches drawn with numpy
from a seed, and the comparisons with their tolerances.

Tolerances (ROADMAP D10), elementwise abs and rel: float32 within 1e-4,
bfloat16 within 2e-2.  Decode caches are bfloat16 in both packages whatever
the parameters are, so a float32 model's cache entries are held within 2e-2
abs and rel, as ``tests/test_torch_train.py`` holds the dense family's: a k
or v that differs in its last float32 bits can round to the neighbouring
bf16 value, and a decode step reads the rounded cache back, so a later
layer's k or v can be a few bf16 steps off.  A bfloat16 model's caches are
held within 5e-2 in relative 2-norm, as ``tests/test_torch_models.py``
holds them.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as jax_config
from repro.models.api import build as jax_build
from repro_torch.configs.base import get_config
from repro_torch.convert import load_reference_params
from repro_torch.models.api import build

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
FIXTURES = Path(__file__).parent / "fixtures" / "torch"


def golden_path(arch: str) -> Path:
    return FIXTURES / f"golden_{arch}_smoke.npz"


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


def configs(arch, **kw):
    """(reference cfg, port cfg) of the smoke config with ``kw`` set."""
    return (dataclasses.replace(jax_config(arch, smoke=True), **kw),
            dataclasses.replace(get_config(arch, smoke=True), **kw))


def reference(jcfg):
    """(reference api, params from PRNGKey(0))."""
    api = jax_build(jcfg)
    params, _ = api.init(jax.random.PRNGKey(0))
    return api, params


def port(tcfg, params):
    api = build(tcfg, device="cpu")
    load_reference_params(api.model, to_numpy(params))
    return api


def numpy_batch(cfg, seed, batch=2, seq=24, labels=True):
    """tokens (and labels), a VLM's ``vision`` and Whisper's ``frames``
    (standard normal, float32), drawn with numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, seq))}
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab, (batch, seq))
    if cfg.family == "vlm":
        out["vision"] = rng.standard_normal(
            (batch, cfg.vision_tokens, cfg.d_model), dtype=np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (batch, cfg.enc_seq, cfg.d_model), dtype=np.float32)
    return out


def jax_batch(nb, dtype="float32"):
    return {k: jnp.asarray(v, jnp.int32) if v.dtype.kind == "i"
            else jnp.asarray(v, getattr(jnp, dtype)) for k, v in nb.items()}


def torch_batch(nb, dtype="float32"):
    return {k: torch.from_numpy(v) if v.dtype.kind == "i"
            else torch.from_numpy(v).to(getattr(torch, dtype))
            for k, v in nb.items()}


def close(got, want, dtype, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype],
                               err_msg=what)


def cache_close(got, want, dtype, what):
    """A bf16 cache leaf: within 2e-2 of a float32 model's, within 5e-2 in
    relative 2-norm of a bf16 model's."""
    assert str(got.dtype).split(".")[-1] == str(want.dtype), what
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2,
                                   err_msg=what)
    else:
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= 5e-2, f"{what}: relative 2-norm error {err}"


def assert_trees_close(got, want, what, atol=None, rtol=0.0, scaled=None):
    got, want = leaves(got), leaves(want)
    assert sorted(got) == sorted(want), what
    for k in want:
        assert got[k].shape == want[k].shape, f"{what} {k}"
        a = atol if scaled is None else \
            scaled * max(float(np.abs(want[k]).max()), 1e-30)
        np.testing.assert_allclose(got[k], want[k], atol=a, rtol=rtol,
                                   err_msg=f"{what} {k}")


def reference_generate(japi, params, batch, prompt_len, gen):
    """The reference's serving loop (``repro.launch.serve``): prefill over
    the whole batch, then ``gen - 1`` greedy decode steps."""
    prefill = jax.jit(japi.prefill)
    decode = jax.jit(japi.decode)
    logits, cache = prefill(params, batch)
    first = np.asarray(logits, np.float32)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    outs = [np.asarray(tok)]
    for i in range(gen - 1):
        logits, cache = decode(params, cache, tok, jnp.int32(prompt_len + i))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        outs.append(np.asarray(tok))
    return first, np.stack(outs, 1)
