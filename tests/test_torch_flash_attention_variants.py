"""Which CUDA kernel each dtype runs, and what the bf16 tensor-core kernels
take, checked on the CPU (no CUDA, no compiler).

The flash-attention forward (K2), the dq pass (K3) and the dk/dv pass (K4)
run on fp32 FMAs for float32 and on the tensor cores for bfloat16; the
choice is a pure function of the dtype.  The tensor-core kernels move
16-byte rows, so the wrappers reject inputs that do not start on a 16-byte
boundary or whose strides are not multiples of 8 elements; that check is a
pure function of the tensors' pointers and strides.  On CPU tensors the wrappers run their
plain versions as before, whatever the layout.  Last, the roundings that
only the tensor-core kernels do (P to bf16 in K2; dS to bf16 in K3; P and
dS as a bf16 high plus a bf16 low part in K4) are emulated in float64 and
held against the plain versions with the on-card bf16 tolerance (2e-2 abs
+ rel).
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel, kernel_bwd

BF16 = torch.bfloat16
TOL = 2e-2


@pytest.mark.parametrize("module", [kernel, kernel_bwd],
                         ids=["fwd", "dkv"])
@pytest.mark.parametrize("dtype,variant", [(torch.float32, "fp32 fma"),
                                           (torch.bfloat16, "bf16 mma")])
def test_kernel_variant_is_chosen_by_dtype_alone(module, dtype, variant):
    assert module._kernel_variant(dtype) == variant
    assert kernel._KERNEL_CODES[variant] in (0, 1)


@pytest.mark.parametrize("module", [kernel, kernel_bwd],
                         ids=["fwd", "dkv"])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_kernel_variant_refuses_other_dtypes(module, dtype):
    with pytest.raises(TypeError, match="no flash-attention"):
        module._kernel_variant(dtype)


def _buffer(n):
    return torch.zeros(n + 64, dtype=BF16)


def _model_layout(B, S, heads, hd):
    """[B, S, heads, hd] seen as [B, heads, S, hd], as the model hands it."""
    return torch.zeros(B, S, heads, hd, dtype=BF16).transpose(1, 2)


def _offset(elements):
    """A [1, 2, 64, 64] view starting `elements` past an aligned start."""
    buf = _buffer(2 * 64 * 64)
    assert buf.data_ptr() % 16 == 0
    return buf[elements:elements + 2 * 64 * 64].view(1, 2, 64, 64)


LAYOUTS = {
    "contiguous": (lambda: torch.zeros(2, 4, 64, 64, dtype=BF16), None),
    "model layout hd 80": (lambda: _model_layout(2, 100, 4, 80), None),
    "model layout hd 16, 3 heads": (lambda: _model_layout(1, 33, 3, 16),
                                    None),
    "model layout hd 128, Sq 1": (lambda: _model_layout(1, 1, 2, 128), None),
    "offset by 16 bytes": (lambda: _offset(8), None),
    "offset by 2 bytes": (lambda: _offset(1), "16-byte boundary"),
    "offset by 8 bytes": (lambda: _offset(4), "16-byte boundary"),
    "row stride 68": (lambda: torch.zeros(1, 2, 64, 68, dtype=BF16)[..., :64],
                      "multiples of 8"),
    "head stride 4100": (lambda: torch.as_strided(
        _buffer(3 * 4100), (1, 3, 64, 64), (3 * 4100, 4100, 64, 1)),
        "multiples of 8"),
    "batch stride 12 with batch 2": (lambda: torch.as_strided(
        _buffer(4096), (2, 1, 1, 16), (12, 16, 16, 1)), "multiples of 8"),
    "odd strides of size-1 dims": (lambda: torch.as_strided(
        _buffer(4096), (1, 1, 1, 16), (7, 5, 3, 1)), None),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_mma_layout_check(name):
    make, want = LAYOUTS[name]
    x = make()
    good = torch.zeros(1, 2, 64, 64, dtype=BF16)
    for i, args in ((0, (x,)), (1, (good, x, good))):
        err = kernel._mma_layout_error(*args)
        if want is None:
            assert err is None
        else:
            assert want in err and f"input {i} " in err


def _inputs(shape, dtype, seed):
    """q, k, v, dO from a numpy seed, as [B, S, heads, hd] seen as [B, heads,
    S, hd] (the model layout)."""
    B, H, KV, Sq, Skv, hd, _ = shape
    rng = np.random.default_rng(seed)

    def make(heads, s):
        a = rng.standard_normal((B, s, heads, hd), dtype=np.float32)
        return torch.from_numpy(a).to(dtype).transpose(1, 2)
    return make(H, Sq), make(KV, Skv), make(KV, Skv), make(H, Sq)


SHAPES = [(1, 4, 2, 70, 90, 64, True),
          (2, 2, 1, 33, 50, 80, False),
          (1, 2, 2, 1, 40, 128, False)]


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"hd{s[5]}")
def test_cpu_wrappers_run_the_plain_versions(monkeypatch, shape, dtype):
    """CPU tensors never reach a kernel, a compiler or the layout check:
    the wrappers return the plain versions' results bit for bit."""
    def no_compiler(*a, **k):
        raise AssertionError("the CPU path must not build or load a kernel")
    monkeypatch.setattr(_build, "load_library", no_compiler)
    causal = shape[-1]
    q, k, v, do = _inputs(shape, dtype, seed=7)
    before = (kernel.flash_attention_bhsd.launches,
              kernel_bwd.flash_attention_bwd_dq.launches,
              kernel_bwd.flash_attention_bwd_dkv.launches)
    o, lse = kernel.flash_attention_bhsd(q, k, v, causal=causal)
    o_p, lse_p = kernel.flash_attention_plain(q, k, v, causal=causal)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    dq, delta = kernel_bwd.flash_attention_bwd_dq(q, k, v, o, lse, do,
                                                  causal=causal)
    dq_p, delta_p = kernel_bwd.bwd_dq_plain(q, k, v, o, lse, do,
                                            causal=causal)
    assert torch.equal(dq, dq_p) and torch.equal(delta, delta_p)
    got = kernel_bwd.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                             causal=causal)
    want = kernel_bwd.bwd_dkv_plain(q, k, v, do, lse, delta, causal=causal)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (kernel.flash_attention_bhsd.launches,
            kernel_bwd.flash_attention_bwd_dq.launches,
            kernel_bwd.flash_attention_bwd_dkv.launches) == before


def test_cpu_wrappers_take_layouts_the_tensor_core_kernels_refuse():
    q = _offset(1)
    k = v = torch.zeros(1, 2, 64, 64, dtype=BF16)
    o, lse = kernel.flash_attention_bhsd(q, k, v)
    assert torch.equal(o, kernel.flash_attention_plain(q, k, v)[0])
    dq, delta = kernel_bwd.flash_attention_bwd_dq(q, k, v, q, lse, q)
    assert tuple(dq.shape) == (1, 2, 64, 64)
    dk, dv = kernel_bwd.flash_attention_bwd_dkv(q, k, v, q, lse, lse)
    assert tuple(dk.shape) == tuple(dv.shape) == (1, 2, 64, 64)


def test_wrapper_errors_are_unchanged():
    x = torch.zeros(1, 2, 8, 16)
    with pytest.raises(TypeError, match="must share float32 or bfloat16"):
        kernel.flash_attention_bhsd(x.half(), x.half(), x.half())
    with pytest.raises(ValueError, match="not a multiple of"):
        kernel.flash_attention_bhsd(torch.zeros(1, 3, 8, 16), x, x)
    with pytest.raises(ValueError, match="delta must be float32"):
        kernel_bwd.flash_attention_bwd_dkv(x, x, x, x, x[..., 0],
                                           x[..., 0].double())
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernel_bwd.flash_attention_bwd_dkv(*(t.to("meta") for t in (
            x, x, x, x, x[..., 0], x[..., 0])))


# ---- the tensor-core kernels' arithmetic, emulated ------------------------

def _split(x):
    """x as a bf16 high part plus a bf16 low part (K4's A operands)."""
    hi = x.to(BF16).double()
    return hi + (x - hi).to(BF16).double()


def _emulated_fwd(q, k, v, causal, tile=64):
    """K2 on the tensor cores: fp32 scores of bf16 operands, an online
    softmax over 64-key tiles, P rounded to bf16 before P . V."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    kk = k.double().repeat_interleave(H // KV, 1)
    vv = v.double().repeat_interleave(H // KV, 1)
    s = q.double() @ kk.transpose(-1, -2) / math.sqrt(hd)
    if causal:
        keep = torch.arange(Sq)[:, None] >= torch.arange(Skv)[None, :]
        s = s.masked_fill(~keep, -1e30)
    m = torch.full((B, H, Sq, 1), -1e30, dtype=torch.float64)
    l = torch.zeros(B, H, Sq, 1, dtype=torch.float64)
    acc = torch.zeros(B, H, Sq, hd, dtype=torch.float64)
    for j in range(0, Skv, tile):
        st = s[..., j:j + tile]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        p = torch.exp(st - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(BF16).double() @ vv[..., j:j + tile, :]
        m = m_new
    return (acc / l).to(BF16), (m + torch.log(l))[..., 0].float()


def _emulated_dq(q, k, v, o, lse, do, causal, split=False):
    """K3 on the tensor cores: fp32 scores of bf16 operands, delta =
    rowsum(dO O) in fp32, dS rounded to bf16 once (or, with ``split``, as
    a bf16 high plus a bf16 low part) before dQ = scale dS K; in bf16."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    kk = k.double().repeat_interleave(H // KV, 1)
    vv = v.double().repeat_interleave(H // KV, 1)
    scale = 1.0 / math.sqrt(hd)
    delta = (do.float() * o.float()).sum(-1)
    p = torch.exp(q.double() @ kk.transpose(-1, -2) * scale
                  - lse.double()[..., None])
    if causal:
        keep = torch.arange(Sq)[:, None] >= torch.arange(Skv)[None, :]
        p = p * keep
    ds = p * (do.double() @ vv.transpose(-1, -2) - delta.double()[..., None])
    a = _split(ds) if split else ds.to(BF16).double()
    return (a @ kk * scale).to(BF16), delta


def _emulated_dkv(q, k, v, do, lse, delta, causal):
    """K4 on the tensor cores: P and dS split into bf16 high and low parts
    before dV = P^T dO and dK = scale dS^T Q; per query head, in bf16."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    kk = k.double().repeat_interleave(H // KV, 1)
    vv = v.double().repeat_interleave(H // KV, 1)
    scale = 1.0 / math.sqrt(hd)
    s = q.double() @ kk.transpose(-1, -2) * scale
    p = torch.exp(s - lse.double()[..., None])
    if causal:
        keep = torch.arange(Sq)[:, None] >= torch.arange(Skv)[None, :]
        p = p * keep
    dp = do.double() @ vv.transpose(-1, -2)
    ds = p * (dp - delta.double()[..., None])
    dv = _split(p).transpose(-1, -2) @ do.double()
    dk = _split(ds).transpose(-1, -2) @ q.double() * scale
    return dk.to(BF16), dv.to(BF16)


EMULATED = [(1, 8, 1, 384, 384, 64, True),    # G = 8, as TinyLlama's
            (1, 4, 4, 256, 256, 80, True),    # Zamba2-2.7B's head dim
            (2, 4, 2, 130, 200, 128, False),
            (1, 6, 3, 100, 70, 16, True)]


@pytest.mark.parametrize("shape", EMULATED, ids=lambda s: f"hd{s[5]}")
def test_tensor_core_roundings_stay_within_the_bf16_tolerance(shape):
    """The kernels' extra roundings, emulated, against the plain versions
    (and the GQA sum) with the tolerance chip_smoke.py holds the kernels
    to on the card."""
    causal = shape[-1]
    q, k, v, do = _inputs(shape, BF16, seed=11)
    o_p, lse_p = kernel.flash_attention_plain(q, k, v, causal=causal)
    o_e, lse_e = _emulated_fwd(q, k, v, causal)
    torch.testing.assert_close(o_e.float(), o_p.float(), atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse_e, lse_p, atol=TOL, rtol=TOL)

    _, delta = kernel_bwd.bwd_dq_plain(q, k, v, o_p, lse_p, do,
                                       causal=causal)
    want = kernel_bwd.bwd_dkv_plain(q, k, v, do, lse_p, delta,
                                    causal=causal)
    got = _emulated_dkv(q, k, v, do, lse_p, delta, causal)
    KV = k.shape[1]
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=TOL, rtol=TOL)
        torch.testing.assert_close(
            kernel_bwd.group_sum(g, KV, BF16).float(),
            kernel_bwd.group_sum(w, KV, BF16).float(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize(
    "shape", EMULATED + [(1, 8, 1, 1024, 1024, 64, True)],   # G = 8, S 1024
    ids=lambda s: f"hd{s[5]}-S{s[3]}")
def test_dq_tensor_core_rounding_stays_within_the_bf16_tolerance(shape):
    """K3's one extra rounding (dS to bf16), emulated, against the plain
    pass A with the tolerance chip_smoke.py holds the kernel to on the
    card; delta is the plain version's bit for bit."""
    causal = shape[-1]
    q, k, v, do = _inputs(shape, BF16, seed=13)
    o, lse = kernel.flash_attention_plain(q, k, v, causal=causal)
    dq_p, delta_p = kernel_bwd.bwd_dq_plain(q, k, v, o, lse, do,
                                            causal=causal)
    dq_e, delta_e = _emulated_dq(q, k, v, o, lse, do, causal)
    assert torch.equal(delta_e, delta_p)
    torch.testing.assert_close(dq_e.float(), dq_p.float(), atol=TOL,
                               rtol=TOL)
