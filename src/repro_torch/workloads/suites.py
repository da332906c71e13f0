"""Built-in workload suites (paper Table 5 analogues).

Registered with :func:`repro_torch.workloads.register_workload`:

  ``archs``      the architecture configs of ``repro_torch.configs``,
                 lowered to decoder-block GEMM stacks (systolic) and op
                 streams (cachesim / opstream)
  ``mlperf``     the MLPerf-Inference-style model set the paper's GPU
                 tables sweep
  ``polybench``  PolyBench kernels: 2mm/3mm GEMM chains + 2D/3D stencils
  ``cnn``        a standalone residual conv block

Every lowering imports its backend module lazily - importing this module
costs only ``repro_torch.configs`` (pure dataclasses).  The graph-walking
``tpu_graph`` lowering of the reference is not ported (ROADMAP A10).
"""

from __future__ import annotations

from types import SimpleNamespace

from repro_torch.workloads.spec import register_workload

_POLY_BYTES = 4          # PolyBench kernels run on fp32-sized elements


# ---------------------------------------------------------------------------
# shared lowering helpers
# ---------------------------------------------------------------------------

def transformer_gemms(cfg, seq: int, n_layers: int = 2):
    """The GEMM list of a decoder block stack (systolic workload input)."""
    from repro_torch.backends.systolic import GemmLayer
    hd = cfg.hd
    kvd = cfg.kv_heads * hd
    layers = []
    for i in range(n_layers):
        layers += [
            GemmLayer(f"L{i}.qkv", seq, cfg.d_model + 2 * kvd, cfg.d_model),
            GemmLayer(f"L{i}.scores", seq, seq, hd),
            GemmLayer(f"L{i}.pv", seq, hd, seq),
            GemmLayer(f"L{i}.o", seq, cfg.d_model, cfg.d_model),
            GemmLayer(f"L{i}.up", seq, cfg.d_ff or cfg.d_model * 4,
                      cfg.d_model),
            GemmLayer(f"L{i}.down", seq, cfg.d_model,
                      cfg.d_ff or cfg.d_model * 4),
        ]
    return layers


def transformer_program(cfg, seq: int, n_layers: int = 2):
    """Op-stream program for the cache-hierarchy ("gpu") backend."""
    def program(sb):
        from repro_torch.backends.opstream import transformer_ops
        transformer_ops(sb, cfg.d_model, max(cfg.n_heads, 1),
                        max(cfg.kv_heads, 1), cfg.d_ff or 4 * cfg.d_model,
                        seq, n_layers=n_layers,
                        moe_experts=cfg.moe_experts,
                        moe_topk=cfg.moe_topk)
    return program


# ---------------------------------------------------------------------------
# "archs" suite
# ---------------------------------------------------------------------------

_ARCH_BACKENDS = ("systolic", "cachesim", "opstream")


def _register_arch(arch: str) -> None:
    @register_workload(
        arch, suite="archs",
        description=f"decoder-block stack of the {arch} config",
        params={"seq": 128, "n_layers": 2},
        backends=_ARCH_BACKENDS)
    def _build(params, backend, _arch=arch):
        from repro_torch.configs.base import get_config
        # trace size is governed by seq, not params: full config dims
        cfg = get_config(_arch, smoke=False)
        seq, n_layers = params["seq"], params["n_layers"]
        if backend == "systolic":
            return transformer_gemms(cfg, seq, n_layers), {}
        return transformer_program(cfg, seq, n_layers), {"sample": 8}


def _register_archs() -> None:
    from repro_torch.configs.base import ARCH_IDS
    for arch in ARCH_IDS:
        _register_arch(arch)


_register_archs()


# ---------------------------------------------------------------------------
# "mlperf" suite
# ---------------------------------------------------------------------------

def _register_transformer(name, *, d_model, n_heads, kv_heads, d_ff, seq,
                          n_layers, sample, moe_experts=0, moe_topk=0,
                          suite="mlperf"):
    @register_workload(
        name, suite=suite,
        description=f"{name} decoder stack "
                    f"(d_model={d_model}, {n_layers} layer(s))",
        params={"d_model": d_model, "n_heads": n_heads,
                "kv_heads": kv_heads, "d_ff": d_ff, "seq": seq,
                "n_layers": n_layers, "moe_experts": moe_experts,
                "moe_topk": moe_topk, "sample": sample},
        backends=("systolic", "cachesim", "opstream"))
    def _build(params, backend):
        p = dict(params)
        sample = p.pop("sample")
        dims = SimpleNamespace(
            d_model=p["d_model"], n_heads=p["n_heads"],
            kv_heads=p["kv_heads"], d_ff=p["d_ff"],
            hd=p["d_model"] // p["n_heads"], moe_experts=p["moe_experts"],
            moe_topk=p["moe_topk"])
        if backend == "systolic":
            return transformer_gemms(dims, p["seq"], p["n_layers"]), {}
        return (transformer_program(dims, p["seq"], p["n_layers"]),
                {"sample": sample})


_register_transformer("bert-base-uncased", d_model=768, n_heads=12,
                      kv_heads=12, d_ff=3072, seq=128, n_layers=2,
                      sample=8)
_register_transformer("gpt-j-6b", d_model=4096, n_heads=16, kv_heads=16,
                      d_ff=16384, seq=64, n_layers=1, sample=32)
_register_transformer("llama-3.2-1b", d_model=2048, n_heads=32,
                      kv_heads=8, d_ff=8192, seq=64, n_layers=1,
                      sample=16)
_register_transformer("llama-3-8b", d_model=4096, n_heads=32, kv_heads=8,
                      d_ff=14336, seq=64, n_layers=1, sample=32)
_register_transformer("phi-moe-sample", d_model=1024, n_heads=16,
                      kv_heads=4, d_ff=4096, seq=64, n_layers=1,
                      sample=16, moe_experts=8, moe_topk=2)

_RESNET_BLOCKS = {
    "resnet-18": [(56, 64, 64, 3), (28, 128, 64, 3), (14, 256, 128, 3),
                  (7, 512, 256, 3)],
    "resnet-50": [(56, 64, 64, 1), (56, 64, 64, 3), (56, 256, 64, 1),
                  (28, 128, 256, 1), (28, 128, 128, 3),
                  (28, 512, 128, 1), (14, 256, 512, 1),
                  (14, 256, 256, 3), (7, 512, 1024, 1)],
}


def _register_resnet(name, blocks, sample, suite="mlperf"):
    @register_workload(
        name, suite=suite,
        description=f"{name} conv stages as im2col GEMMs + batch norms",
        params={"sample": sample},
        backends=("systolic", "cachesim", "opstream"))
    def _build(params, backend, _blocks=tuple(blocks)):
        if backend == "systolic":
            from repro_torch.backends.systolic import conv_as_gemm
            return [conv_as_gemm(f"c{i}.conv", hw, oc, ic, k)
                    for i, (hw, oc, ic, k) in enumerate(_blocks)], {}

        def program(sb):
            from repro_torch.backends.opstream import resnet_ops
            resnet_ops(sb, list(_blocks))
        return program, {"sample": params["sample"]}


_register_resnet("resnet-18", _RESNET_BLOCKS["resnet-18"], sample=4)
_register_resnet("resnet-50", _RESNET_BLOCKS["resnet-50"], sample=8)
_register_resnet("resnet-block", [(28, 128, 128, 3), (28, 128, 128, 3)],
                 sample=2, suite="cnn")


@register_workload(
    "stable-diffusion", suite="mlperf",
    description="UNet-ish mix: conv stages + low-res self-attention + "
                "channel MLPs (the paper's pathological L2 refresh case)",
    params={"sample": 8},
    backends=("cachesim", "opstream"))
def _stable_diffusion(params, backend):
    def program(sb):
        from repro_torch.backends.opstream import (resnet_ops,
                                                   transformer_ops)
        resnet_ops(sb, [(64, 320, 320, 3), (32, 640, 640, 3)])
        transformer_ops(sb, d_model=1280, n_heads=8, kv_heads=8,
                        d_ff=5120, seq=64, n_layers=1)
        resnet_ops(sb, [(32, 640, 640, 3)])
    return program, {"sample": params["sample"]}


# ---------------------------------------------------------------------------
# "polybench" suite
# ---------------------------------------------------------------------------

def _register_polyconv(name, dim, n, sample):
    @register_workload(
        name, suite="polybench",
        description=f"PolyBench {dim}D convolution: one {n}^{dim} "
                    "stencil pass",
        params={"n": n, "sample": sample},
        backends=("cachesim", "opstream"))
    def _build(params, backend, _dim=dim):
        def program(sb):
            from repro_torch.backends.opstream import polybench_conv_ops
            polybench_conv_ops(sb, dim=_dim, n=params["n"])
        return program, {"sample": params["sample"]}


_register_polyconv("polybench-2DConv", dim=2, n=192, sample=2)
_register_polyconv("polybench-3DConv", dim=3, n=40, sample=4)


def _mm_chain(params, backend, gemms):
    """Shared 2mm/3mm lowering: a GEMM chain given as
    ``(name, M, N, K, a_key, b_key, out_key)`` tuples over named
    matrices (inputs allocated on first use, outputs chained)."""
    if backend == "systolic":
        from repro_torch.backends.systolic import GemmLayer
        return [GemmLayer(name, M, N, K)
                for name, M, N, K, _a, _b, _o in gemms], {}

    def program(sb):
        mats: dict = {}

        def mat(key, rows, cols):
            if key not in mats:
                mats[key] = sb.alloc(key, rows * cols * _POLY_BYTES)
            return mats[key]

        for name, M, N, K, a_key, b_key, out_key in gemms:
            sb.gemm(name, mat(a_key, M, K), mat(b_key, K, N),
                    mat(out_key, M, N), M, N, K, _POLY_BYTES)
    return program, {"sample": params["sample"]}


@register_workload(
    "polybench-2mm", suite="polybench",
    description="PolyBench 2mm: D = (A @ B) @ C, two chained GEMMs",
    params={"ni": 128, "nj": 112, "nk": 96, "nl": 144, "sample": 1},
    backends=("systolic", "cachesim", "opstream"))
def _polybench_2mm(params, backend):
    ni, nj, nk, nl = (params[k] for k in ("ni", "nj", "nk", "nl"))
    return _mm_chain(params, backend, [
        ("2mm.mm1", ni, nj, nk, "A", "B", "tmp"),
        ("2mm.mm2", ni, nl, nj, "tmp", "C", "D"),
    ])


@register_workload(
    "polybench-3mm", suite="polybench",
    description="PolyBench 3mm: G = (A @ B) @ (C @ D), three GEMMs",
    params={"ni": 128, "nj": 112, "nk": 96, "nl": 144, "nm": 80,
            "sample": 1},
    backends=("systolic", "cachesim", "opstream"))
def _polybench_3mm(params, backend):
    ni, nj, nk, nl, nm = (params[k]
                          for k in ("ni", "nj", "nk", "nl", "nm"))
    return _mm_chain(params, backend, [
        ("3mm.mm1", ni, nj, nk, "A", "B", "E"),
        ("3mm.mm2", nj, nl, nm, "C", "D", "F"),
        ("3mm.mm3", ni, nl, nj, "E", "F", "G"),
    ])
