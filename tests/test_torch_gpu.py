"""Tests of the port that need the card (marked ``gpu``; they skip here).

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports neither ``jax`` nor the reference package, so it runs
where only PyTorch is installed.  Each CUDA kernel is held against its plain
version on the same inputs with the CPU tests' tolerances (the backward
kernels in float32 within 1e-5; the bf16 tensor-core kernels within the
bf16 tolerances and bit-equal from run to run; the lifetime scan exactly,
on structured streams that put segment edges on the kernel's range edges;
the cache replay bit for bit, on random, skewed and near-2^59 streams,
200 k accesses in one set and set counts at S - 1, S and S + 1;
the policy kernels with exact counts and picks and energy within 1e-12),
and the serving and training paths with the kernels against the JAX
reference's golden fixtures.
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


def _ssd_inputs(cuda, shape, dtype, seed):
    b, l, h, p, n, _ = shape
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(b, l, h, p, generator=g, device=cuda).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(b, l, h, generator=g, device=cuda))
    A = -torch.exp(0.5 * torch.randn(h, generator=g, device=cuda))
    B = torch.randn(b, l, n, generator=g, device=cuda).to(dtype)
    C = torch.randn(b, l, n, generator=g, device=cuda).to(dtype)
    D = torch.randn(h, generator=g, device=cuda)
    return x, dt, A, B, C, D


# (b, l, h, p, n, chunk): Zamba2-2.7B's widths at the serving length, one
# chunk, ragged chunks; Mamba-2-130M's state; the smoke configs' widths;
# p 8 with n 128
SSD_SHAPES = [(2, 300, 80, 64, 64, 256),
              (1, 100, 8, 16, 16, 32),
              (1, 37, 3, 8, 128, 16),
              (4, 1024, 80, 64, 64, 256),
              (1, 256, 8, 64, 64, 256),
              (2, 300, 8, 64, 64, 64),
              (1, 520, 4, 64, 128, 256),
              (2, 100, 8, 16, 16, 32),
              (1, 70, 3, 8, 16, 16),
              (1, 90, 2, 24, 48, 48)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-4),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_scan_kernel_matches_plain(cuda, shape, dtype, tol):
    """K5 against its plain version; bf16 x, B and C run the tensor-core
    kernels, two runs bit-equal."""
    from repro_torch.kernels.ssd_scan import kernel, ops
    l, chunk = shape[1], shape[-1]
    x, dt, A, B, C, D = _ssd_inputs(cuda, shape, dtype, seed=1)
    assert kernel._kernel_variant(x.dtype, B.dtype) == \
        ("bf16 mma" if dtype == torch.bfloat16 else "fp32 fma")
    before = kernel.ssd_scan_chunked.launches
    y = ops.ssd_scan(x, dt, A, B, C, D, chunk=chunk)
    torch.cuda.synchronize()
    assert kernel.ssd_scan_chunked.launches == before + 1
    assert torch.equal(y, ops.ssd_scan(x, dt, A, B, C, D, chunk=chunk))
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


# every head dim the kernels are built for, GQA, ragged Sq and Skv, Sq = 1,
# causal and not: (B, H, KV, Sq, Skv, hd, causal)
MMA_SHAPES = [(2, 4, 2, 100, 130, 16, True),
              (1, 6, 3, 64, 200, 32, False),
              (2, 8, 2, 129, 129, 48, True),
              (1, 4, 1, 1, 50, 64, False),
              (2, 4, 4, 200, 70, 80, True),
              (1, 6, 2, 77, 77, 96, False),
              (1, 4, 2, 33, 160, 112, True),
              (2, 2, 1, 150, 150, 128, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", MMA_SHAPES,
                         ids=[f"hd{s[5]}" for s in MMA_SHAPES])
def test_bf16_tensor_core_kernels_match_plain(cuda, shape):
    """K2, K3 and K4 in bfloat16 (the tensor-core kernels) against their
    plain versions within the bf16 tolerance, two runs bit-equal."""
    from repro_torch.kernels.flash_attention import kernel, kernel_bwd
    causal = shape[-1]
    q, k, v, do = _bwd_inputs(cuda, shape, torch.bfloat16, seed=4)
    assert kernel._kernel_variant(q.dtype) == "bf16 mma"
    assert kernel_bwd._kernel_variant(q.dtype) == "bf16 mma"
    before = kernel.flash_attention_bhsd.launches
    o, lse = kernel.flash_attention_bhsd(q, k, v, causal=causal)
    o2, lse2 = kernel.flash_attention_bhsd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernel.flash_attention_bhsd.launches == before + 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    o_p, lse_p = kernel.flash_attention_plain(q, k, v, causal=causal)
    _close(o, o_p, 2e-2)
    _close(lse, lse_p, 2e-2)

    before = kernel_bwd.flash_attention_bwd_dq.launches
    dq, delta = kernel_bwd.flash_attention_bwd_dq(q, k, v, o_p, lse_p, do,
                                                  causal=causal)
    dq2, delta2 = kernel_bwd.flash_attention_bwd_dq(q, k, v, o_p, lse_p, do,
                                                    causal=causal)
    torch.cuda.synchronize()
    assert kernel_bwd.flash_attention_bwd_dq.launches == before + 2
    assert torch.equal(dq, dq2) and torch.equal(delta, delta2)
    dq_p, delta_p = kernel_bwd.bwd_dq_plain(q, k, v, o_p, lse_p, do,
                                            causal=causal)
    _close(dq, dq_p, 2e-2)
    _close(delta, delta_p, 1e-4)            # fp32 sums in another order

    delta = delta_p
    before = kernel_bwd.flash_attention_bwd_dkv.launches
    got = kernel_bwd.flash_attention_bwd_dkv(q, k, v, do, lse_p, delta,
                                             causal=causal)
    again = kernel_bwd.flash_attention_bwd_dkv(q, k, v, do, lse_p, delta,
                                               causal=causal)
    torch.cuda.synchronize()
    assert kernel_bwd.flash_attention_bwd_dkv.launches == before + 2
    want = kernel_bwd.bwd_dkv_plain(q, k, v, do, lse_p, delta,
                                    causal=causal)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        _close(g, w, 2e-2)


@pytest.mark.gpu
def test_bf16_tensor_core_kernels_raise_on_unaligned_inputs(cuda):
    """A bf16 call the tensor-core kernels cannot take raises; it never
    goes to the FMA kernel or to the plain version."""
    from repro_torch.kernels.flash_attention import kernel, kernel_bwd
    shape = (1, 2, 64, 64)
    n = 2 * 64 * 64
    buf = torch.randn(n + 1, device=cuda).to(torch.bfloat16)
    q = buf[1:].view(shape)                     # 2 bytes past a boundary
    k, v, do = (torch.randn(shape, device=cuda).to(torch.bfloat16)
                for _ in range(3))
    lse = torch.zeros(shape[:3], device=cuda)
    before = (kernel.flash_attention_bhsd.launches,
              kernel_bwd.flash_attention_bwd_dq.launches,
              kernel_bwd.flash_attention_bwd_dkv.launches)
    with pytest.raises(ValueError, match="16-byte"):
        kernel.flash_attention_bhsd(q, k, v)
    with pytest.raises(ValueError, match="16-byte"):
        kernel_bwd.flash_attention_bwd_dq(q, k, v, do, lse, do)
    with pytest.raises(ValueError, match="16-byte"):
        kernel_bwd.flash_attention_bwd_dq(k, k, v, q, lse, do)   # o
    with pytest.raises(ValueError, match="16-byte"):
        kernel_bwd.flash_attention_bwd_dkv(q, k, v, do, lse, lse)
    rows = torch.randn(1, 2, 64, 68, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        kernel.flash_attention_bhsd(rows[..., :64], k, v)  # row stride 68
    with pytest.raises(ValueError, match="multiples of 8"):
        kernel_bwd.flash_attention_bwd_dq(k, k, v, k, lse, rows[..., :64])
    assert (kernel.flash_attention_bhsd.launches,
            kernel_bwd.flash_attention_bwd_dq.launches,
            kernel_bwd.flash_attention_bwd_dkv.launches) == before


@pytest.mark.gpu
def test_bf16_ssd_tensor_core_kernels_raise_outside_their_limits(cuda):
    """A bf16 call the tensor-core SSD kernels cannot take raises; it never
    goes to the FMA kernel or to the plain version."""
    from repro_torch.kernels.ssd_scan import kernel
    x, dt, A, B, C, D = _ssd_inputs(cuda, (1, 64, 2, 16, 16, 32),
                                    torch.bfloat16, seed=7)
    before = kernel.ssd_scan_chunked.launches
    buf = torch.empty(x.numel() + 1, device=cuda, dtype=torch.bfloat16)
    shifted = buf[1:].view(x.shape).copy_(x)    # 2 bytes past a boundary
    with pytest.raises(ValueError, match="16-byte"):
        kernel.ssd_scan_chunked(shifted, dt, A, B, C, D, chunk=32)
    with pytest.raises(ValueError, match="multiples of 16"):
        kernel.ssd_scan_chunked(x, dt, A, B, C, D, chunk=8)
    with pytest.raises(ValueError, match="a multiple of 8"):
        kernel.ssd_scan_chunked(x[..., :12], dt, A, B, C, D, chunk=32)
    assert kernel.ssd_scan_chunked.launches == before


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


def _k1_case(case, dev):
    """K1's structured cases on the card, sorted by (addr, time): one
    segment across every range, one kind of event only, segments exactly
    one warp slice or one block range long (shifted by 0 or 1 event), and
    streams that fill every range exactly, or one event short or over."""
    from repro_torch.kernels.lifetime_scan import kernel
    g = torch.Generator(device=dev).manual_seed(0)

    def arange(n):
        return torch.arange(n, device=dev, dtype=torch.int64)

    def random(n, n_addrs, p_write):
        t = torch.randint(0, 10 * n, (n,), generator=g, device=dev)
        a = torch.randint(0, n_addrs, (n,), generator=g, device=dev)
        w = torch.rand(n, generator=g, device=dev) < p_write
        by_t = torch.sort(t, stable=True).indices
        order = by_t[torch.sort(a[by_t], stable=True).indices]
        return t[order], a[order], w[order]

    n = 2_000_000
    if case == "long_segment":
        i = arange(10_000_001)
        return 3 * i + 2 ** 40, torch.full_like(i, 7), i == 0
    if case in ("reads_only", "writes_only"):
        return random(n, n // 8, 0.0 if case == "reads_only" else 1.0)
    if case.startswith(("slice", "range")):
        slice_, _ = kernel.launch_grid(n, 64, dev)
        length = slice_ * (8 if case.startswith("range") else 1)
        shift = int(case[-1])
        i = arange(n)
        return 3 * i, (i - shift) // length, (i - shift) % length == 0
    slice_, blocks = kernel.launch_grid(n, 64, dev)
    m = 8 * slice_ * blocks + {"minus1": -1, "exact": 0, "plus1": 1}[
        case.split("_")[-1]]
    return random(m, m // 8, 0.35)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    "long_segment", "reads_only", "writes_only", "slice_shift0",
    "slice_shift1", "range_shift0", "range_shift1", "full_ranges_minus1",
    "full_ranges_exact", "full_ranges_plus1"])
def test_lifetime_scan_kernel_matches_plain_on_structured_cases(cuda, case):
    from repro_torch.kernels.lifetime_scan import kernel
    from repro_torch.kernels.lifetime_scan.ops import (default_edges,
                                                       integer_edges)
    t, a, w = _k1_case(case, cuda)
    e = torch.from_numpy(integer_edges(default_edges())).to(cuda)
    before = kernel.lifetime_scan_sorted.launches
    hist, stats = kernel.lifetime_scan_sorted(t, a, w, e)
    torch.cuda.synchronize()
    assert kernel.lifetime_scan_sorted.launches == before + 1
    h_p, s_p = kernel.lifetime_scan_plain(t, a, w, e)
    assert torch.equal(hist, h_p) and torch.equal(stats, s_p)
    assert int(stats[4] + stats[5]) == t.shape[0]


# the ``counts`` kinds of B6's cases: every set holds S plus one of these
B6_COUNT_DELTAS = {"s_minus_1": [-1], "s": [0], "s_plus_1": [1],
                   "s_mixed": [-1, 0, 1]}
# a one-set stream longer than this is held against the plain version on
# its first B6_PREFIX accesses (one set: results are causal) and against
# a plain LRU on the host on all of them: the plain version's slot loop
# syncs with the host on every slot
B6_PREFIX = 2000


def _b6_stream(n, n_sets, ways, seed, dev, kind="random"):
    """Line addresses and write flags on the card for B6's cases; the
    ``B6_COUNT_DELTAS`` kinds give every set exactly S - 1, S or S + 1
    accesses (cycling through the three for ``s_mixed``), S being the split
    replay's chunk length for that stream, so that chunk edges fall just
    before, on and just after set edges."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind in B6_COUNT_DELTAS:
        from repro_torch.kernels.cache_replay import kernel
        S = kernel.SPLIT_MIN_PER_WAY * ways
        delta = B6_COUNT_DELTAS[kind]
        per_set = torch.tensor([S + delta[i % len(delta)]
                                for i in range(n_sets)], device=dev)
        n = int(per_set.sum())
        # the chunk length the wrapper picks for this stream is S
        assert kernel.split_plan(n, ways, dev)[0] == S
        sets = torch.repeat_interleave(torch.arange(n_sets, device=dev),
                                       per_set)
        sets = sets[torch.randperm(n, generator=g, device=dev)]
        tags = torch.randint(0, 3 * ways, (n,), generator=g, device=dev)
        lines = sets + n_sets * tags
        return lines, torch.rand(n, generator=g, device=dev) < 0.35
    lines = torch.randint(0, 8 + 3 * n_sets * ways, (n,), generator=g,
                          device=dev)
    if kind == "skew":                # every access in set 0
        lines = (lines % 64) * n_sets
    if kind == "few":                 # three lines, all in set 0
        lines = (lines % 3) * n_sets
    if kind == "top":                 # line addresses near 2**59 - 1
        lines = 2 ** 59 - 1 - lines
    return lines, torch.rand(n, generator=g, device=dev) < 0.35


def _lru_words(lines, w, ways, write_allocate):
    """Result words of one set's stream by a plain LRU on the host (an
    ordered dict of line -> dirty, least recent first)."""
    from collections import OrderedDict
    state, out = OrderedDict(), []
    for a, write in zip(lines.tolist(), w.tolist()):
        if a in state:
            state.move_to_end(a)
            state[a] |= write
            out.append(1)
        elif not write_allocate and write:
            out.append(0)
        else:
            evict, dirty = (state.popitem(last=False)
                            if len(state) == ways else (-1, False))
            state[a] = write
            out.append(((evict + 1) << 3) | (int(dirty) << 2) | 2)
    return torch.tensor(out, dtype=torch.int64)


@pytest.mark.gpu
@pytest.mark.parametrize("write_allocate", [True, False])
@pytest.mark.parametrize("n_sets,ways,n,kind", [
    (1, 2, 3000, "random"), (2, 1, 3000, "random"), (8, 4, 20000, "random"),
    (128, 8, 200000, "random"), (2048, 16, 200000, "random"),
    (4096, 16, 300000, "random"), (16, 3, 20000, "random"),
    (4, 32, 20000, "random"), (128, 8, 20000, "skew"),
    (64, 4, 20000, "top"), (128, 8, 0, "random"),
    (128, 8, 200000, "skew"), (128, 8, 200000, "few"),
    (128, 8, None, "s_minus_1"), (128, 8, None, "s"),
    (128, 8, None, "s_plus_1"), (64, 16, None, "s_mixed"),
    (16, 3, None, "s_mixed")])
def test_cache_replay_kernel_matches_plain(cuda, n_sets, ways, n, kind,
                                           write_allocate):
    """B6 bit-equal to its plain version, and to itself on a second run;
    one wrapper call counted per call, none for an empty stream.  The
    write policy picks the kernel: the split replay under write-allocate
    (here also on 200 k accesses in one set and on set counts at S - 1, S
    and S + 1), the per-set chain otherwise."""
    from repro_torch.kernels.cache_replay import kernel
    from repro_torch.kernels.cache_replay.ops import partition_by_set
    lines, w = _b6_stream(n, n_sets, ways, n_sets + ways, cuda, kind)
    n = lines.shape[0]
    order, offsets, counts = partition_by_set(lines, n_sets)
    packed = (lines * 2 + w.to(torch.int64))[order]
    before = kernel.cache_replay_sorted.launches
    got = kernel.cache_replay_sorted(packed, offsets, counts, ways,
                                     write_allocate)
    again = kernel.cache_replay_sorted(packed, offsets, counts, ways,
                                       write_allocate)
    torch.cuda.synchronize()
    assert kernel.cache_replay_sorted.launches == before + 2 * (n > 0)
    assert torch.equal(again, got)
    if n and int(counts.max()) > 20000:
        assert int(counts[0]) == n                 # one set: set 0
        head = kernel.cache_replay_plain(
            packed[:B6_PREFIX], torch.zeros_like(offsets),
            torch.clamp(counts, max=B6_PREFIX), ways, write_allocate)
        assert torch.equal(got[:B6_PREFIX], head)
        want = _lru_words(lines // n_sets, w, ways, write_allocate)
        ev = (want >> 3) - 1                       # lines of set 0
        want = torch.where(ev >= 0, ((ev * n_sets + 1) << 3) | (want & 7),
                           want)
        assert torch.equal(got.cpu(), want)
    else:
        want = kernel.cache_replay_plain(packed, offsets, counts, ways,
                                         write_allocate)
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_cache_replay_kernel_limits_and_hierarchy(cuda):
    """More ways than the kernel takes raise (ROADMAP D19); the hierarchy
    on the card equals the same hierarchy on the CPU, with two launches."""
    from repro_torch.backends import cachesim
    from repro_torch.kernels.cache_replay import kernel
    p = torch.zeros(4, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="up to 32 ways"):
        kernel.cache_replay_sorted(p, p[:1], p[:1], 33, True)
    rng = np.random.RandomState(3)
    n = 100_000
    t = np.arange(n, dtype=np.int64)
    a = (rng.randint(0, 1 << 16, n) * 128).astype(np.int64)
    w = rng.rand(n) < 0.3
    for wa in (True, False):
        cfg = cachesim.HierarchyConfig(write_allocate=wa)
        before = kernel.cache_replay_sorted.launches
        plain = kernel.cache_replay_plain.calls
        got = cachesim.simulate_hierarchy(t, a, w, cfg, device=cuda)
        assert kernel.cache_replay_sorted.launches == before + 2
        assert kernel.cache_replay_plain.calls == plain
        want = cachesim.simulate_hierarchy(t, a, w, cfg, device="cpu")
        for f in ("time_cycles", "addr", "is_write", "hit", "subpartition"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def _b7_inputs(seg_len, C, D, seed, device):
    """Address-sorted lifetimes with integer reads and bits, the
    value-sorted side, and [C, D] candidates with NaN in padded slots."""
    rng = np.random.RandomState(seed)
    seg_len = np.asarray(seg_len, np.int64)
    L = int(seg_len.sum())
    lt = rng.lognormal(np.log(2e-6), 2.0, L)
    bits = np.where(rng.rand(L) < 0.8, 256.0, 1024.0)
    rb = rng.poisson(3.0, L) * bits
    seg = np.repeat(np.arange(len(seg_len), dtype=np.int32), seg_len)
    starts = np.concatenate([[0], np.cumsum(seg_len)[:-1]])
    order = np.argsort(lt, kind="stable")
    n_dev = rng.randint(1, D + 1, C).astype(np.int32)
    n_dev[0] = D
    cand = np.full((3, C, D), np.nan)
    for c in range(C):
        cand[0, c, :n_dev[c]] = np.where(rng.rand(n_dev[c]) < 0.2, np.inf,
                                         rng.lognormal(np.log(2e-6), 2.0,
                                                       n_dev[c]))
        cand[1:, c, :n_dev[c]] = rng.uniform(0.5, 20.0, (2, n_dev[c]))

    def put(a, dt=torch.float64):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)

    cands = (put(cand[0]), put(cand[1]), put(cand[2]),
             put(n_dev, torch.int32))
    value = (put(lt[order]),
             put(np.concatenate([[0.0], np.cumsum(bits[order])])),
             put(np.concatenate([[0.0], np.cumsum(rb[order])])),
             put(np.sort(np.maximum.reduceat(lt, starts))))
    addr = (put(lt), put(rb), put(bits), put(seg, torch.int32),
            put(np.add.reduceat(bits, starts)), put(np.add.reduceat(rb,
                                                                    starts)))
    return cands, value, addr


def _b7_runs(cands, value, addr):
    """(wrapper, plain, args) of every B7 kernel on one input: the
    refresh-free kernel, the retention pass with and without address
    groups, the two candidate passes and the decision per address."""
    from repro_torch.kernels.compose_policy import kernel as k
    from repro_torch.kernels.compose_policy import ops
    ret, rf, wf, n_dev = cands
    C, D = ret.shape
    pad = np.arange(D)[None, :] >= n_dev.cpu().numpy()[:, None]
    ret_u, ridx = ops.retention_index(ret.cpu().numpy(), pad)
    dev = ret.device
    ret_u = torch.from_numpy(ret_u).to(dev)
    ridx = torch.from_numpy(ridx).to(dev)
    lt, rb, bits, seg, abits, arbits = addr
    A = abits.shape[0]
    rs, _ = k.policy_retention_plain(ret_u, lt, bits, seg, A)
    # a candidate pass takes up to MAX_RETENTIONS rows: the first group
    lo, hi, rows = ops.retention_groups(ridx.cpu().numpy(), len(ret_u))[0]
    u, r = ops._local_index(ret_u.cpu().numpy(), ridx.cpu().numpy(), lo, hi,
                            rows)
    cand = (torch.from_numpy(u).to(dev), torch.from_numpy(r).to(dev),
            rf[lo:hi], wf[lo:hi], n_dev[lo:hi], lt, rb, bits)
    # each output: compared exactly, or (energy, floor partials) summed
    # per row within 1e-12
    return [(k.policy_rf, k.policy_rf_plain, (*cands, *value),
             ("sum", "exact")),
            (k.policy_retention, k.policy_retention_plain,
             (ret_u, lt, bits, seg, A), ("exact", "sum")),
            (k.policy_retention, k.policy_retention_plain,
             (ret_u, lt, bits), ("exact", "sum")),
            (k.policy_ra_grouped, k.policy_ra_grouped_plain, cand, ("sum",)),
            (k.policy_ra_ungrouped, k.policy_ra_ungrouped_plain, cand,
             ("sum", "exact")),
            (k.policy_ra_decide, k.policy_ra_decide_plain,
             (ridx, rf, wf, n_dev, rs, abits, arbits), ("exact",))]


@pytest.mark.gpu
@pytest.mark.parametrize("seg_len,C,D", [
    ([1] * 20_000, 7, 3),                       # one lifetime per address
    ([50_000], 5, 16),                          # one address, many ranges
    ([1, 30_001, 1024, 1023, 1025, 8, 7, 9, 2], 20, 5),
    (list(np.random.RandomState(1).geometric(0.1, 3000)), 33, 9),
])
def test_compose_policy_kernels_match_plain(cuda, seg_len, C, D):
    """B7: counts, picks and per-address refresh sums exactly, energy and
    floor sums within 1e-12 relative of the plain version, two runs
    bit-equal, one launch per call."""
    cands, value, addr = _b7_inputs(seg_len, C, D, len(seg_len), cuda)
    for fn, plain, args, kinds in _b7_runs(cands, value, addr):
        before = fn.launches
        got = fn(*args)
        again = fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == before + 2
        want = plain(*args)
        if isinstance(got, torch.Tensor):
            got, again, want = (got,), (again,), (want,)
        for g, a, w, kind in zip(got, again, want, kinds):
            if w is None:
                assert g is None and a is None
                continue
            assert torch.equal(g, a)                 # run to run
            if kind == "exact":       # counts, picks, per-address sums
                assert torch.equal(g, w)
            else:                     # per-block partials, summed per row
                torch.testing.assert_close(
                    g.sum(dim=-1) if g.dim() > 1 else g,
                    w.sum(dim=-1) if w.dim() > 1 else w, rtol=1e-12, atol=0)
    # the host-facing entry points, retention groups and all
    from repro_torch.kernels.compose_policy import ops
    ret, n_dev = cands[0], cands[3]
    pad = np.arange(D)[None, :] >= n_dev.cpu().numpy()[:, None]
    ret_u, ridx = ops.retention_index(ret.cpu().numpy(), pad)
    cpu = tuple(x.cpu() for x in cands)
    got = ops.refresh_aware_ungrouped(cands, ret_u, ridx, *addr[:3])
    want = ops.refresh_aware_ungrouped(cpu, ret_u, ridx,
                                       *(x.cpu() for x in addr[:3]))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=0)
    got = ops.refresh_aware_grouped(cands, ret_u, ridx, *addr)
    want = ops.refresh_aware_grouped(cpu, ret_u, ridx,
                                     *(x.cpu() for x in addr))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=0)
    lt, bits = addr[0], addr[2]
    np.testing.assert_allclose(
        ops.floor_refresh_bits(ret_u, lt, bits),
        ops.floor_refresh_bits(ret_u, lt.cpu(), bits.cpu()), rtol=1e-12,
        atol=0)


@pytest.mark.gpu
def test_compose_policy_limits_and_torch_engine_on_the_card(cuda):
    """More than 16 device slots raise on the card (ROADMAP D26); the
    torch engine on the card (the default) equals the NumPy engine
    (capacity exactly, energy 1e-9) and goes through the kernels, not the
    plain versions."""
    from repro_torch.backends.systolic import GemmLayer
    from repro_torch.core import ProfileSession
    from repro_torch.kernels.compose_policy import kernel as k
    from repro_torch.sweep import DeviceGrid
    z = torch.zeros(2, 17, dtype=torch.float64, device=cuda)
    n = torch.ones(2, dtype=torch.int32, device=cuda)
    e = torch.zeros(1, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="up to 16 device slots"):
        k.policy_rf(z, z, z, n, e, torch.zeros(2, dtype=torch.float64,
                                                device=cuda),
                    torch.zeros(2, dtype=torch.float64, device=cuda), e)
    s = ProfileSession("systolic", device=cuda)
    s.profile([GemmLayer("a", 48, 64, 64), GemmLayer("b", 32, 48, 96)],
              rows=32, cols=32).analyze()
    grid = DeviceGrid(mixes=(0.0, 0.5, 1.0), retention_scales=(0.5, 1, 2))
    for policy in ("refresh-free", "refresh-aware", "bank-quantized"):
        plain = [f.calls for f in k.PLAIN]
        launches = k.policy_rf.launches + k.policy_ra_grouped.launches
        got = s.sweep(grid, policy=policy).points
        assert k.policy_rf.launches + k.policy_ra_grouped.launches == \
            launches + 3
        assert [f.calls for f in k.PLAIN] == plain
        want = s.sweep(grid, policy=policy, engine="numpy").points
        for a, b in zip(got, want):
            ca, cb = a.composition, b.composition
            assert np.array_equal(ca.capacity_fractions,
                                  cb.capacity_fractions)
            assert ca.energy_j == pytest.approx(cb.energy_j, rel=1e-9, abs=0)
            assert ca.energy_vs_sram == pytest.approx(cb.energy_vs_sram,
                                                      rel=1e-9, abs=0)
            for name, e in cb.monolithic_energy_j.items():
                assert ca.monolithic_energy_j[name] == pytest.approx(
                    e, rel=1e-9, abs=0)


@pytest.mark.gpu
def test_tiny_campaign_on_the_card_equals_the_cpu(cuda, tmp_path):
    """``polybench-2mm`` x ``systolic,gpu`` at small sizes through
    ``CampaignRunner`` with two threads: the card's run (B6 for the gpu
    job, B7 for every compose and sweep) has the CPU run's accesses,
    short-lived and capacity fractions exactly and its sweep energies
    within 1e-9."""
    from repro_torch.kernels.cache_replay import kernel as b6
    from repro_torch.kernels.compose_policy import kernel as b7
    from repro_torch.launch.campaign import (CampaignRunner, campaign_facts,
                                             compare_campaign_facts)
    kw = dict(params={"polybench-2mm": {"ni": 24, "nj": 20, "nk": 16,
                                        "nl": 28}},
              backend_cfg={"systolic": {"rows": 16, "cols": 16}},
              sweep_axes={"mixes": (0.0, 1.0), "retention_scales": (1.0,),
                          "per_mix": False}, jobs=2)
    facts = {}
    for dev in ("cpu", cuda):
        launches = (b6.cache_replay_sorted.launches, b7.policy_rf.launches)
        result = CampaignRunner("polybench-2mm", ("systolic", "gpu"),
                                cache_dir=str(tmp_path / str(dev)),
                                device=dev, **kw).run()
        assert result.failed == 0 and result.executed == 2
        after = (b6.cache_replay_sorted.launches, b7.policy_rf.launches)
        if dev == "cpu":
            assert after == launches
        else:
            assert after[0] == launches[0] + 2 and after[1] > launches[1]
        facts[str(dev)] = campaign_facts(result.artifacts, result.aggregate)
    assert compare_campaign_facts(facts[str(cuda)], facts["cpu"]) <= 1e-9


@pytest.mark.gpu
def test_short_lived_fraction_on_the_card_keeps_boundary_lifetimes(cuda):
    """Lifetimes of exactly k * 1000 cycles at 1 GHz lie on k us: the
    card's short-lived fraction classifies them as the host's true division
    does (a scalar divisor would be a reciprocal product on the card)."""
    from repro_torch.core.lifetime import (extract_lifetimes,
                                           short_lived_fraction)
    lts = np.array([999, 1000, 1001, 3000, 5000, 7000, 9000, 10000, 10001,
                    13000, 21000, 99000], np.int64)
    n = len(lts)
    time_cycles = np.stack([np.zeros(n, np.int64), lts], 1).ravel()
    addr = np.repeat(np.arange(n, dtype=np.int64) * 64, 2)
    is_write = np.tile([True, False], n)
    hit = np.ones(2 * n, bool)
    for ret in (1e-6, 3e-6, 5e-6, 7e-6, 9e-6, 1e-5, 1.3e-5, 2.1e-5, 9.9e-5):
        want = float((lts / 1e9 <= ret).sum() / n)
        for dev in ("cpu", cuda):
            st = extract_lifetimes(time_cycles, addr, is_write, hit,
                                   device=dev)
            assert short_lived_fraction(st, 1e9, ret) == want, (dev, ret)
