"""The port's flash-attention backward against the JAX reference (CPU).

Inputs come from a numpy seed.  The JAX side runs its Pallas backward
kernels in interpret mode (``flash_attention_bwd_bhsd``, 64-row blocks) and
sums the per-query-head dk/dv over the GQA groups as its ``ops.py`` does;
the port, given CPU tensors, runs the kernels' plain versions.  Tolerances
are the reference's own backward tolerances (``tests/test_kernels.py``):
atol 3e-5 / rtol 3e-4 in float32; 2e-2 in bfloat16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import \
    flash_attention_bhsd as jax_fwd
from repro.kernels.flash_attention.kernel_bwd import \
    flash_attention_bwd_bhsd as jax_bwd
from repro.kernels.flash_attention.ops import \
    flash_attention as jax_flash_attention
from repro_torch.kernels.flash_attention import kernel, kernel_bwd, ops
from repro_torch.models.layers import reference_attention

FA_SHAPES = [
    # (B, H, KV, Sq, Skv, hd, causal): tests/test_kernels.py's
    (1, 2, 2, 128, 128, 64, True),
    (2, 4, 2, 256, 256, 32, True),
    (1, 4, 1, 64, 192, 64, False),
    (1, 2, 2, 100, 100, 64, True),
    (2, 3, 1, 77, 130, 16, False),
    (1, 8, 2, 256, 100, 64, True),
]
IDS = [f"B{b}H{h}KV{k}q{q}k{s}d{d}{'c' if c else 'f'}"
       for b, h, k, q, s, d, c in FA_SHAPES]
TOL = {"float32": (3e-5, 3e-4), "bfloat16": (2e-2, 2e-2)}


def _inputs(shape, dtype, seed=0):
    """q, k, v, do as (jax arrays, torch tensors) holding equal values."""
    B, H, KV, Sq, Skv, hd, _ = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, H, Sq, hd), (B, KV, Skv, hd), (B, KV, Skv, hd),
                      (B, H, Sq, hd))]
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(np.array(a, np.float32)).to(
        getattr(torch, dtype)) for a in jx]
    return jx, tx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _jax_backward(q, k, v, do, causal):
    """The reference's kernels (interpret mode) + its GQA group-sum."""
    o, lse = jax_fwd(q, k, v, causal=causal, q_block=64, kv_block=64,
                     interpret=True)
    dq, dk_h, dv_h = jax_bwd(q, k, v, o, lse, do, causal=causal,
                             q_block=64, kv_block=64, interpret=True)
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    dk = dk_h.reshape(B, KV, G, Skv, hd).sum(2).astype(k.dtype)
    dv = dv_h.reshape(B, KV, G, Skv, hd).sum(2).astype(v.dtype)
    return o, lse, (dq, dk, dv)


@pytest.mark.parametrize("shape", FA_SHAPES[:4], ids=IDS[:4])
def test_plain_backward_matches_pallas_kernels(shape):
    causal = shape[-1]
    (qj, kj, vj, doj), _ = _inputs(shape, "float32")
    o, lse, want = _jax_backward(qj, kj, vj, doj, causal)
    args = [torch.from_numpy(np.asarray(a)) for a in (qj, kj, vj, o, lse,
                                                     doj)]
    got = kernel_bwd.flash_attention_bwd_plain(*args, causal=causal)
    atol, rtol = TOL["float32"]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(_np(g), _np(w), atol=atol, rtol=rtol,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FA_SHAPES, ids=IDS)
def test_wrapper_runs_plain_passes_on_cpu_and_matches_reference(shape,
                                                                 dtype):
    """The wrapper on CPU tensors: the two plain passes, no launch, equal to
    the plain whole; against the reference's kernels in both dtypes."""
    causal = shape[-1]
    (qj, kj, vj, doj), (qt, kt, vt, dot) = _inputs(shape, dtype, seed=1)
    o_j, lse_j, want = _jax_backward(qj, kj, vj, doj, causal)
    o_t, lse_t = kernel.flash_attention_bhsd(qt, kt, vt, causal=causal)
    before = (kernel_bwd.flash_attention_bwd_dq.launches,
              kernel_bwd.flash_attention_bwd_dkv.launches)
    got = kernel_bwd.flash_attention_bwd_bhsd(qt, kt, vt, o_t, lse_t, dot,
                                              causal=causal)
    assert (kernel_bwd.flash_attention_bwd_dq.launches,
            kernel_bwd.flash_attention_bwd_dkv.launches) == before
    plain = kernel_bwd.flash_attention_bwd_plain(qt, kt, vt, o_t, lse_t, dot,
                                                 causal=causal)
    atol, rtol = TOL[dtype]
    for name, g, p, w, x in zip(("dq", "dk", "dv"), got, plain, want,
                                (qt, kt, vt)):
        assert g.dtype == x.dtype and g.shape == x.shape, name
        assert torch.equal(g, p), name
        np.testing.assert_allclose(_np(g), _np(w), atol=atol, rtol=rtol,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_matches_autograd_through_reference_attention(causal):
    """d/d(q, k, v) of sum(sin(flash_attention)) in the model layout, against
    autograd through the naive reference attention (float32)."""
    rng = np.random.default_rng(4)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((2, 50, 6, 16), (2, 70, 2, 16), (2, 70, 2, 16))]
    a = [torch.from_numpy(x).requires_grad_() for x in arrs]
    b = [torch.from_numpy(x.copy()).requires_grad_() for x in arrs]
    torch.sin(ops.flash_attention(*a, causal=causal)).sum().backward()
    torch.sin(reference_attention(*b, causal=causal)).sum().backward()
    for name, x, y in zip("qkv", a, b):
        torch.testing.assert_close(x.grad, y.grad, atol=3e-5, rtol=3e-4,
                                   msg=f"d{name}")


def test_autograd_matches_the_reference_custom_vjp():
    """The port's autograd Function against the reference's custom VJP
    (Pallas forward and backward in interpret mode), model layout."""
    rng = np.random.default_rng(5)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((1, 64, 4, 32), (1, 64, 2, 32), (1, 64, 2, 32))]
    w = rng.standard_normal((1, 64, 4, 32), dtype=np.float32)

    def loss_j(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, causal=True, q_block=32,
                                           kv_block=32) * w)
    want = jax.grad(loss_j, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    t = [torch.from_numpy(x).requires_grad_() for x in arrs]
    (ops.flash_attention(*t, causal=True) * torch.from_numpy(w)).sum() \
        .backward()
    for name, x, y in zip("qkv", t, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(y), atol=3e-5,
                                   rtol=3e-4, err_msg=f"d{name}")


def test_gradient_flows_through_flash_attention():
    """Formerly forward-only: now a tensor that requires grad gets its
    gradient, and under no_grad nothing is recorded."""
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    k = torch.randn(1, 8, 2, 16, requires_grad=True)
    out = ops.flash_attention(q, k, k)
    assert out.requires_grad and out.shape == q.shape
    out.sum().backward()
    assert q.grad is not None and k.grad is not None
    assert bool(q.grad.isfinite().all()) and bool(k.grad.isfinite().all())
    with torch.no_grad():
        assert not ops.flash_attention(q, k, k).requires_grad


def test_backward_passes_match_the_whole_plain_backward():
    """Pass A's delta is rowsum(dO * O); pass B with it gives the plain
    whole's per-head dk/dv; GQA sums them."""
    _, (q, k, v, do) = _inputs((2, 6, 3, 40, 56, 16, True), "float32", 7)
    o, lse = kernel.flash_attention_plain(q, k, v, causal=True)
    dq, delta = kernel_bwd.flash_attention_bwd_dq(q, k, v, o, lse, do)
    torch.testing.assert_close(delta, (do * o).sum(-1), atol=1e-6,
                               rtol=1e-6)
    dk_h, dv_h = kernel_bwd.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    assert dk_h.shape == (2, 6, 56, 16)
    whole = kernel_bwd.flash_attention_bwd_plain(q, k, v, o, lse, do)
    assert torch.equal(dq, whole[0])
    assert torch.equal(kernel_bwd.group_sum(dk_h, 3, k.dtype), whole[1])
    assert torch.equal(kernel_bwd.group_sum(dv_h, 3, v.dtype), whole[2])


def test_backward_wrapper_rejects_what_the_kernels_do_not_take():
    q = torch.zeros(1, 2, 4, 16)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="lse"):
        kernel_bwd.flash_attention_bwd_bhsd(q, q, q, q, lse[..., :3], q)
    with pytest.raises(ValueError, match="o/do"):
        kernel_bwd.flash_attention_bwd_bhsd(q, q, q, q, lse, q[..., :3, :])
    with pytest.raises(ValueError, match="delta"):
        kernel_bwd.flash_attention_bwd_dkv(q, q, q, q, lse, lse.double())
    meta = q.to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernel_bwd.flash_attention_bwd_bhsd(meta, meta, meta, meta,
                                            lse.to("meta"), meta)
