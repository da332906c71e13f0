"""Built-in workload suites (paper Table 5 analogues).

Registered with :func:`repro_torch.workloads.register_workload`:

  ``archs``      the architecture configs of ``repro_torch.configs``,
                 lowered to decoder-block GEMM stacks
  ``polybench``  PolyBench 2mm/3mm GEMM chains

Only the systolic lowerings exist so far: asking a spec for another
backend raises the registry's ``ValueError``.  Every lowering imports its
backend module lazily - importing this module costs only
``repro_torch.configs`` (pure dataclasses).
"""

from __future__ import annotations

from repro_torch.workloads.spec import register_workload


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


# ---------------------------------------------------------------------------
# "archs" suite
# ---------------------------------------------------------------------------

_ARCH_BACKENDS = ("systolic",)


def _register_arch(arch: str) -> None:
    @register_workload(
        arch, suite="archs",
        description=f"decoder-block stack of the {arch} config",
        params={"seq": 128, "n_layers": 2},
        backends=_ARCH_BACKENDS)
    def _build(params, backend, _arch=arch):
        from repro_torch.configs.base import get_config
        # trace size is governed by seq, not params: full config dims
        return transformer_gemms(get_config(_arch, smoke=False),
                                 params["seq"], params["n_layers"]), {}


def _register_archs() -> None:
    from repro_torch.configs.base import ARCH_IDS
    for arch in ARCH_IDS:
        _register_arch(arch)


_register_archs()


# ---------------------------------------------------------------------------
# "polybench" suite
# ---------------------------------------------------------------------------

def _mm_chain(gemms):
    """Shared 2mm/3mm systolic lowering: a GEMM chain given as
    ``(name, M, N, K)`` tuples."""
    from repro_torch.backends.systolic import GemmLayer
    return [GemmLayer(name, M, N, K) for name, M, N, K in gemms], {}


@register_workload(
    "polybench-2mm", suite="polybench",
    description="PolyBench 2mm: D = (A @ B) @ C, two chained GEMMs",
    params={"ni": 128, "nj": 112, "nk": 96, "nl": 144, "sample": 1},
    backends=("systolic",))
def _polybench_2mm(params, backend):
    ni, nj, nk, nl = (params[k] for k in ("ni", "nj", "nk", "nl"))
    return _mm_chain([
        ("2mm.mm1", ni, nj, nk),
        ("2mm.mm2", ni, nl, nj),
    ])


@register_workload(
    "polybench-3mm", suite="polybench",
    description="PolyBench 3mm: G = (A @ B) @ (C @ D), three GEMMs",
    params={"ni": 128, "nj": 112, "nk": 96, "nl": 144, "nm": 80,
            "sample": 1},
    backends=("systolic",))
def _polybench_3mm(params, backend):
    ni, nj, nk, nl, nm = (params[k]
                          for k in ("ni", "nj", "nk", "nl", "nm"))
    return _mm_chain([
        ("3mm.mm1", ni, nj, nk),
        ("3mm.mm2", nj, nl, nm),
        ("3mm.mm3", ni, nl, nj),
    ])
