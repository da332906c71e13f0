"""Tests of the port that need the card (marked ``gpu``; they skip here).

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports neither ``jax`` nor the reference package, so it runs
where only PyTorch is installed.  Each CUDA kernel is held against its plain
version on the same inputs with the CPU tests' tolerances, and the serving
path with the kernels against the JAX reference's golden fixture.
``python3 chip_smoke.py`` is the full on-card check.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

GOLDEN = Path(__file__).parent / "fixtures" / "torch" / \
    "golden_zamba2_smoke.npz"


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
