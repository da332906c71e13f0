"""The VLM (InternVL2-1B) and audio (Whisper-small) families against the JAX
reference (CPU, smoke configs), and the three families' golden fixtures.

InternVL2 prepends its ``vision_proj``-projected patch embeddings to the
tokens: the cache covers vision and text positions and the loss only the
text.  Whisper encodes the mel frames without a causal mask and decodes with
cross-attention; its ``prefill`` returns a *zero* self-attention cache with
the cross k/v filled, as the reference does (ROADMAP D37), so the decode
step after it is compared too.  Both are held in float32 within 1e-4 and in
bfloat16 within 2e-2 (prefill logits, a decode step and its cache, with
``attn_impl`` ``"ref"`` and ``"flash"``), the loss and every gradient leaf
and one optimizer step in float32, the serving loop's greedy tokens, and
the tree through ``convert``.  Tolerances are ``tests/family_oracle.py``'s.

``golden_<arch>_smoke.npz`` (``tests/make_torch_golden.py --only
families``) is what ``chip_smoke.py``'s ``families`` phase holds the card
to; here the port's CPU path reproduces it: prefill logits within 1e-4,
greedy tokens equal, one step's loss and grad norm within 1e-5 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from family_oracle import (TOL, assert_trees_close, cache_close, close,
                           configs, golden_path, jax_batch, numpy_batch,
                           port, reference, reference_generate, to_numpy,
                           torch_batch)
from repro.launch.steps import make_optimizer as jax_make_optimizer
from repro.launch.steps import make_train_step as jax_make_train_step
from repro_torch.configs.base import get_config
from repro_torch.convert import (export_params, load_reference_params,
                                 tree_from_flat)
from repro_torch.launch import serve
from repro_torch.launch.steps import make_optimizer, make_train_step
from repro_torch.models import whisper
from repro_torch.models.api import build

ARCHS = ("internvl2_1b", "whisper_small")
CASES = [(arch, impl, dtype) for arch in ARCHS
         for impl in ("ref", "flash") for dtype in ("float32", "bfloat16")]
GOLDEN_ARCHS = ("deepseek_moe_16b", "internvl2_1b", "whisper_small")
GOLDEN_TOL = {"logits": 1e-4, "loss": 1e-5, "grad_norm": 1e-5, "lr": 1e-6}


@pytest.fixture(scope="module", params=CASES,
                ids=["-".join(c) for c in CASES])
def served(request):
    """Prefill and one decode step through both packages."""
    arch, impl, dtype = request.param
    jcfg, tcfg = configs(arch, attn_impl=impl, param_dtype=dtype)
    japi, params = reference(jcfg)
    api = port(tcfg, params)
    nb = numpy_batch(jcfg, 0, seq=40, labels=False)
    j_logits, j_cache = jax.jit(japi.prefill)(params, jax_batch(nb, dtype))
    t_logits, t_cache = api.prefill(torch_batch(nb, dtype))
    tok = np.asarray(jnp.argmax(j_logits, -1))
    j_logits2, j_cache2 = jax.jit(japi.decode)(
        params, j_cache, jnp.asarray(tok, jnp.int32), jnp.int32(33))
    t_logits2, t_cache2 = api.decode(t_cache, torch.tensor(tok).long(), 33)
    return arch, dtype, (j_logits, j_cache, j_logits2, j_cache2), \
        (t_logits, t_cache, t_logits2, t_cache2)


def cache_leaves(cache):
    """{name: tensor} of a transformer ({"main": (k, v)}) or Whisper cache."""
    if "main" in cache:
        return {f"{key} {n}": t for key, pair in cache.items()
                for n, t in zip("kv", pair)}
    return dict(cache)


def test_prefill_logits_match(served):
    _, dtype, j, t = served
    close(t[0], j[0], dtype, "prefill logits")


def test_prefill_cache_matches(served):
    arch, dtype, j, t = served
    got, want = cache_leaves(t[1]), cache_leaves(j[1])
    assert sorted(got) == sorted(want)
    for key in want:
        cache_close(got[key], want[key], dtype, f"prefill cache {key}")
    if arch == "whisper_small":            # D37: a zero self-attention cache
        assert not bool(got["k"].any()) and not bool(got["v"].any())
        assert got["k"].shape[2] == 40
    else:                                  # sized to vision + text positions
        cfg = get_config(arch, smoke=True)
        assert got["main k"].shape[2] == 40 + cfg.vision_tokens


def test_decode_step_logits_and_cache_match(served):
    _, dtype, j, t = served
    close(t[2], j[2], dtype, "decode logits")
    got, want = cache_leaves(t[3]), cache_leaves(j[3])
    assert sorted(got) == sorted(want)
    for key in want:
        cache_close(got[key], want[key], dtype, f"decode cache {key}")


@pytest.fixture(scope="module", params=ARCHS)
def trained(request):
    arch = request.param
    jcfg, tcfg = configs(arch, param_dtype="float32")
    japi, params = reference(jcfg)
    return arch, jcfg, tcfg, japi, params


@pytest.mark.parametrize("impl", ["ref", "flash"])
def test_loss_and_every_gradient_leaf_match_reference(trained, impl):
    from repro.models.api import build as jax_build
    arch, jcfg, tcfg, _, params = trained
    jcfg = dataclasses.replace(jcfg, attn_impl=impl)
    tcfg = dataclasses.replace(tcfg, attn_impl=impl)
    nb = numpy_batch(jcfg, 1)
    loss_j, grads_j = jax.value_and_grad(jax_build(jcfg).loss)(
        params, jax_batch(nb))
    api = port(tcfg, params)
    loss_t = api.loss(torch_batch(nb))
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j),
                               rtol=TOL["float32"])
    grads_t = export_params({n: p.grad for n, p in
                             api.model.named_parameters()})
    assert_trees_close(grads_t, to_numpy(grads_j), "grad",
                       scaled=TOL["float32"])


def test_one_train_step_matches_reference(trained):
    arch, jcfg, tcfg, japi, params = trained
    nb = numpy_batch(jcfg, 2)
    jopt = jax_make_optimizer(jcfg, total_steps=1)
    jstep = jax.jit(jax_make_train_step(japi, jopt))
    jp, _, jm = jstep(params, jopt.init(params), jax_batch(nb))
    api = port(tcfg, params)
    opt = make_optimizer(api.cfg, total_steps=1)
    tp = dict(api.model.named_parameters())
    tp, _, m = make_train_step(api, opt)(tp, opt.init(tp), torch_batch(nb))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                   rtol=TOL["float32"])
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    assert_trees_close(export_params(tp), to_numpy(jp), "params",
                       atol=TOL["float32"], rtol=TOL["float32"])


def test_remat_gives_the_same_gradients_as_no_remat(trained):
    arch, jcfg, tcfg, _, params = trained
    batch = torch_batch(numpy_batch(jcfg, 3))
    grads = []
    for remat in (True, False):
        api = port(dataclasses.replace(tcfg, remat=remat,
                                       attn_impl="flash"), params)
        api.loss(batch).backward()
        grads.append([p.grad for p in api.model.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_generate_gives_the_references_greedy_tokens(trained):
    arch, jcfg, tcfg, japi, params = trained
    prompt_len, gen = 16, 6
    nb = numpy_batch(jcfg, 4, batch=3, seq=prompt_len + gen, labels=False)
    want_logits, want = reference_generate(japi, params, jax_batch(nb),
                                           prompt_len, gen)
    out = serve.generate(port(tcfg, params), torch_batch(nb), prompt_len,
                         gen)
    np.testing.assert_array_equal(out.tokens.numpy(), want)
    close(out.prefill_logits, want_logits, "float32", "prefill logits")


def test_convert_round_trips_the_tree(trained):
    arch, _, tcfg, _, params = trained
    api = port(tcfg, params)
    tree = export_params(api.model)
    assert_trees_close(tree, to_numpy(params), "export", atol=0)
    groups = ("enc_layers", "dec_layers") if arch == "whisper_small" \
        else ("layers",)
    for g in groups:
        assert tree[g]["attn"]["wq"].shape[0] == len(getattr(api.model, g))
    if arch == "whisper_small":
        assert tree["dec_pos"].shape == (whisper.MAX_DECODER_POS,
                                         tcfg.d_model)
        del tree["dec_layers"]["cross"]["wk"]
    else:
        assert tree["vision_proj"].shape == (tcfg.d_model, tcfg.d_model)
        del tree["vision_proj"]
    with pytest.raises(KeyError):
        load_reference_params(api.model, tree)


def test_cli_serves_and_trains_the_new_families_on_the_cpu(tmp_path):
    from repro_torch.launch.train import main as train_main
    for arch in ("deepseek_moe_16b", "internvl2_1b", "whisper_small"):
        gen = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                          "--prompt-len", "8", "--gen", "3"], device="cpu")
        assert gen.shape == (2, 3)
        log = train_main(["--arch", arch, "--smoke", "--steps", "2",
                          "--batch", "2", "--seq", "16", "--ckpt-dir",
                          str(tmp_path / arch)], device="cpu")
        assert len(log) == 2 and all(np.isfinite(m["loss"]) for m in log)


# ---------------------------------------------------------------------------
# the golden fixtures the card is held to
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", GOLDEN_ARCHS)
def test_port_cpu_path_reproduces_the_family_golden_fixture(arch):
    fx = dict(np.load(golden_path(arch)))
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              attn_impl=str(fx["attn_impl"]),
                              param_dtype="float32")
    api = build(cfg, device="cpu")
    load_reference_params(api.model,
                          tree_from_flat(fx, "param:", api.model))
    sv = {k.split(":", 1)[1]: torch.from_numpy(v) for k, v in fx.items()
          if k.startswith("serve:")}
    out = serve.generate(api, sv, int(fx["prompt_len"]), int(fx["gen"]))
    np.testing.assert_allclose(out.prefill_logits.numpy(),
                               fx["prefill_logits"],
                               atol=GOLDEN_TOL["logits"], rtol=0)
    np.testing.assert_array_equal(out.tokens.numpy(), fx["greedy_tokens"])
    tb = {k.split(":", 1)[1]: torch.from_numpy(v) for k, v in fx.items()
          if k.startswith("train:")}
    opt = make_optimizer(cfg, total_steps=1)
    params = dict(api.model.named_parameters())
    _, _, m = make_train_step(api, opt)(params, opt.init(params), tb)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(fx[k]),
                                   rtol=GOLDEN_TOL[k], err_msg=k)
