"""The port's serving loop against the JAX reference's (CPU), and the golden
fixture the on-card ``golden`` phase of ``chip_smoke.py`` (and
``tests/test_torch_gpu.py``) is held to.

The reference's loop (``repro.launch.serve``): prefill over prompt +
generation tokens, then ``gen - 1`` greedy decode steps at
``prompt_len + i``.  Parameters come from the reference (``PRNGKey(0)``,
float32) and the prompt from a numpy seed; the greedy tokens must be
equal.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models import hybrid as jax_hybrid
from repro.models import mamba2 as jax_mamba
from repro_torch.configs.base import get_config
from repro_torch.convert import load_reference_params, tree_from_flat
from repro_torch.launch import serve
from repro_torch.models.api import build

GOLDEN = Path(__file__).parent / "fixtures" / "torch" / \
    "golden_zamba2_smoke.npz"


def reference_generate(fam, params, cfg, tokens, prompt_len, gen):
    prefill = jax.jit(fam.prefill, static_argnums=1)
    decode = jax.jit(fam.decode_step, static_argnums=1)
    logits, cache = prefill(params, cfg, jnp.asarray(tokens, jnp.int32))
    first = np.asarray(logits, np.float32)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    outs = [np.asarray(tok)]
    for i in range(gen - 1):
        logits, cache = decode(params, cfg, cache, tok,
                               jnp.int32(prompt_len + i))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        outs.append(np.asarray(tok))
    return first, np.stack(outs, 1)


@pytest.mark.parametrize("arch,fam", [("zamba2_2_7b", jax_hybrid),
                                      ("mamba2_130m", jax_mamba)])
def test_generate_gives_the_references_greedy_tokens(arch, fam):
    kw = {"attn_impl": "flash", "param_dtype": "float32"}
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), **kw)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), **kw)
    params, _ = fam.init_lm(jax.random.PRNGKey(0), jcfg)
    prompt_len, gen = 16, 8
    tokens = np.random.default_rng(7).integers(0, jcfg.vocab,
                                               (3, prompt_len + gen))
    want_logits, want = reference_generate(fam, params, jcfg, tokens,
                                           prompt_len, gen)
    api = build(tcfg, device="cpu")
    load_reference_params(api.model,
                          jax.tree.map(lambda a: np.asarray(a, np.float32),
                                       params))
    out = serve.generate(api, torch.from_numpy(tokens), prompt_len, gen)
    assert out.tokens.shape == (3, gen) and out.tokens.dtype == torch.int64
    np.testing.assert_array_equal(out.tokens.numpy(), want)
    np.testing.assert_allclose(out.prefill_logits.numpy(), want_logits,
                               atol=1e-4, rtol=1e-4)
    assert out.prefill_s > 0 and out.decode_s > 0


def test_cli_serves_the_smoke_config_on_the_cpu(capsys):
    gen = serve.main(["--arch", "zamba2_2_7b", "--smoke", "--batch", "2",
                      "--prompt-len", "8", "--gen", "4"], device="cpu")
    assert gen.shape == (2, 4)
    assert ((gen >= 0) & (gen < 256)).all()
    out = capsys.readouterr().out
    assert "prefill:" in out and "decode:" in out
    with pytest.raises(NotImplementedError, match="A11"):
        serve.main(["--arch", "zamba2_2_7b", "--smoke", "--mesh", "host"],
                   device="cpu")


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


def _golden_api(golden, device):
    cfg = dataclasses.replace(get_config("zamba2_2_7b", smoke=True),
                              attn_impl="flash", param_dtype="float32")
    api = build(cfg, device=device)
    load_reference_params(api.model, tree_from_flat(golden))
    return api


def test_golden_fixture_is_what_the_writer_says(golden):
    assert golden["tokens"].shape == (2, 32)
    assert int(golden["prompt_len"]) == 24 and int(golden["gen"]) == 8
    assert golden["prefill_logits"].shape == (2, 256)
    assert golden["greedy_tokens"].shape == (2, 8)
    assert len(np.unique(golden["greedy_tokens"])) > 4   # not degenerate
    assert GOLDEN.stat().st_size < 1 << 20


def test_port_reproduces_the_golden_fixture_on_the_cpu(golden):
    api = _golden_api(golden, "cpu")
    out = serve.generate(api, torch.from_numpy(golden["tokens"]),
                         int(golden["prompt_len"]), int(golden["gen"]))
    np.testing.assert_allclose(out.prefill_logits.numpy(),
                               golden["prefill_logits"], atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_array_equal(out.tokens.numpy(),
                                  golden["greedy_tokens"])
