"""Tests of the port that need the card (marked ``gpu``; they skip here).

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports neither ``jax`` nor the reference package, so it runs
where only PyTorch is installed.  Each CUDA kernel is held against its plain
version on the same inputs with the CPU tests' tolerances (the backward
kernels in float32 within 1e-5, and bit-equal from run to run), and the
serving and training paths with the kernels against the JAX reference's
golden fixtures.
``python3 chip_smoke.py`` is the full on-card check.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

GOLDEN = Path(__file__).parent / "fixtures" / "torch" / \
    "golden_zamba2_smoke.npz"
GOLDEN_TRAIN = Path(__file__).parent / "fixtures" / "torch" / \
    "golden_tinyllama_train_smoke.npz"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-6),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(2, 4, 2, 100, 130, 80, True),
                                   (1, 6, 3, 64, 200, 128, False),
                                   (2, 2, 1, 129, 129, 16, True)])
def test_flash_attention_kernel_matches_plain(cuda, shape, dtype, tol):
    from repro_torch.kernels.flash_attention import kernel
    B, H, KV, Sq, Skv, hd, causal = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(B, Sq, H, hd, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, Skv, KV, hd, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, Skv, KV, hd, generator=g, device=cuda).to(dtype)
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    before = kernel.flash_attention_bhsd.launches
    o, lse = kernel.flash_attention_bhsd(*args, causal=causal)
    torch.cuda.synchronize()
    assert kernel.flash_attention_bhsd.launches == before + 1
    o_p, lse_p = kernel.flash_attention_plain(*args, causal=causal)
    _close(o, o_p, tol)
    _close(lse, lse_p, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-4),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("shape", [(2, 300, 80, 64, 64, 256),
                                   (1, 100, 8, 16, 16, 32),
                                   (1, 37, 3, 8, 128, 16)])
def test_ssd_scan_kernel_matches_plain(cuda, shape, dtype, tol):
    from repro_torch.kernels.ssd_scan import kernel, ops
    b, l, h, p, n, chunk = shape
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(b, l, h, p, generator=g, device=cuda).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(b, l, h, generator=g, device=cuda))
    A = -torch.exp(0.5 * torch.randn(h, generator=g, device=cuda))
    B = torch.randn(b, l, n, generator=g, device=cuda).to(dtype)
    C = torch.randn(b, l, n, generator=g, device=cuda).to(dtype)
    D = torch.ones(h, device=cuda)
    before = kernel.ssd_scan_chunked.launches
    y = ops.ssd_scan(x, dt, A, B, C, D, chunk=chunk)
    torch.cuda.synchronize()
    assert kernel.ssd_scan_chunked.launches == before + 1
    pad = (-l) % chunk
    padded = [torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
              for t in (x, dt, B, C)]
    y_p = kernel.ssd_scan_plain(padded[0], padded[1], A, padded[2],
                                padded[3], D, chunk=chunk)[:, :l]
    _close(y, y_p, tol)


def _bwd_inputs(cuda, shape, dtype, seed):
    B, H, KV, Sq, Skv, hd, causal = shape
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, Sq, H, hd, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, Skv, KV, hd, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, Skv, KV, hd, generator=g, device=cuda).to(dtype)
    do = torch.randn(B, Sq, H, hd, generator=g, device=cuda).to(dtype)
    return [x.transpose(1, 2) for x in (q, k, v, do)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(2, 4, 2, 100, 130, 64, True),
                                   (1, 6, 3, 64, 200, 128, False),
                                   (2, 8, 1, 129, 129, 16, True),
                                   (1, 4, 4, 200, 70, 80, True)])
def test_flash_attention_bwd_kernels_match_plain(cuda, shape, dtype, tol):
    from repro_torch.kernels.flash_attention import kernel, kernel_bwd
    causal = shape[-1]
    q, k, v, do = _bwd_inputs(cuda, shape, dtype, seed=2)
    o, lse = kernel.flash_attention_plain(q, k, v, causal=causal)
    before = (kernel_bwd.flash_attention_bwd_dq.launches,
              kernel_bwd.flash_attention_bwd_dkv.launches)
    got = kernel_bwd.flash_attention_bwd_bhsd(q, k, v, o, lse, do,
                                              causal=causal)
    torch.cuda.synchronize()
    assert (kernel_bwd.flash_attention_bwd_dq.launches,
            kernel_bwd.flash_attention_bwd_dkv.launches) == \
        (before[0] + 1, before[1] + 1)
    again = kernel_bwd.flash_attention_bwd_bhsd(q, k, v, o, lse, do,
                                                causal=causal)
    want = kernel_bwd.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                causal=causal)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)                  # deterministic
        _close(g, w, tol)


@pytest.mark.gpu
def test_flash_attention_autograd_runs_the_kernels(cuda):
    from repro_torch.kernels.flash_attention import kernel, kernel_bwd, ops
    q, k, v, do = _bwd_inputs(cuda, (2, 4, 2, 96, 96, 64, True),
                              torch.float32, seed=3)
    leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    before = (kernel.flash_attention_bhsd.launches,
              kernel_bwd.flash_attention_bwd_dq.launches,
              kernel_bwd.flash_attention_bwd_dkv.launches)
    out = ops.flash_attention(*leaves, causal=True)
    out.backward(do.transpose(1, 2))
    assert (kernel.flash_attention_bhsd.launches,
            kernel_bwd.flash_attention_bwd_dq.launches,
            kernel_bwd.flash_attention_bwd_dkv.launches) == \
        tuple(b + 1 for b in before)
    ref = [x.detach().clone().requires_grad_() for x in leaves]
    B, S, H, hd = ref[0].shape
    qg = ref[0].reshape(B, S, 2, 2, hd)
    s = torch.einsum("bqkgh,bpkh->bkgqp", qg, ref[1]) / hd ** 0.5
    mask = torch.ones(S, S, dtype=torch.bool, device=cuda).tril()
    p = torch.softmax(s.masked_fill(~mask, -1e30), -1)
    o = torch.einsum("bkgqp,bpkh->bqkgh", p, ref[2]).reshape(B, S, H, hd)
    o.backward(do.transpose(1, 2))
    for a, b in zip(leaves, ref):
        _close(a.grad, b.grad, 1e-5)


@pytest.mark.gpu
def test_serving_path_reproduces_the_golden_fixture_on_the_card(cuda):
    from repro_torch.configs.base import get_config
    from repro_torch.convert import load_reference_params, tree_from_flat
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.ssd_scan import kernel as ssd_k
    from repro_torch.launch.serve import generate
    from repro_torch.models.api import build
    golden = dict(np.load(GOLDEN))
    cfg = dataclasses.replace(get_config("zamba2_2_7b", smoke=True),
                              attn_impl="flash", param_dtype="float32")
    api = build(cfg, device=cuda)
    load_reference_params(api.model, tree_from_flat(golden))
    before = fa_k.flash_attention_bhsd.launches, \
        ssd_k.ssd_scan_chunked.launches
    out = generate(api, torch.from_numpy(golden["tokens"]).to(cuda),
                   int(golden["prompt_len"]), int(golden["gen"]))
    assert fa_k.flash_attention_bhsd.launches == before[0] + 2
    assert ssd_k.ssd_scan_chunked.launches == before[1] + 4
    np.testing.assert_allclose(out.prefill_logits.cpu().numpy(),
                               golden["prefill_logits"], atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_array_equal(out.tokens.cpu().numpy(),
                                  golden["greedy_tokens"])


@pytest.mark.gpu
def test_training_path_reproduces_the_train_golden_fixture_on_the_card(cuda):
    from repro_torch.configs.base import get_config
    from repro_torch.convert import (export_params, load_reference_params,
                                     tree_from_flat)
    from repro_torch.kernels.flash_attention import kernel_bwd
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.models.api import build
    fx = dict(np.load(GOLDEN_TRAIN))
    cfg = dataclasses.replace(get_config("tinyllama_1_1b", smoke=True),
                              attn_impl="flash", param_dtype="float32")
    api = build(cfg, device=cuda)
    load_reference_params(api.model, tree_from_flat(fx, "param:"))
    opt = make_optimizer(cfg, total_steps=len(fx["loss"]))
    step = make_train_step(api, opt)
    params = dict(api.model.named_parameters())
    state = opt.init(params)
    before = kernel_bwd.flash_attention_bwd_dq.launches
    for i in range(len(fx["loss"])):
        batch = {k: torch.from_numpy(fx[k][i]).to(cuda)
                 for k in ("tokens", "labels")}
        params, state, m = step(params, state, batch)
        np.testing.assert_allclose(float(m["loss"]), fx["loss"][i],
                                   rtol=1e-5)
    assert kernel_bwd.flash_attention_bwd_dq.launches == \
        before + len(fx["loss"]) * cfg.n_layers
    final = tree_from_flat(fx, "final:")
    got = export_params(params)
    for key in ("embed", "unembed", "ln_f"):
        np.testing.assert_allclose(got[key], final[key], atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_allclose(got["layers"]["attn"]["wq"],
                               final["layers"]["attn"]["wq"], atol=1e-5,
                               rtol=1e-5)
