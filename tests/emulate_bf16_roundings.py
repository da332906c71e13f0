"""How far the bf16 tensor-core kernels' roundings move K3 and K5 from their
plain versions, emulated in float64 on the CPU: the numbers behind the
choice of which operands go in as a single bf16 rounding and which as a
bf16 high plus a bf16 low part.

    PYTHONPATH=src python tests/emulate_bf16_roundings.py

For each case it prints max |emulated - plain| / (tol + tol |plain|), the
share of the on-card tolerance used (tol 2e-2 for K3, 5e-2 for K5): below 1
passes the check that chip_smoke.py makes on the card.

* K3 (dq pass) at TinyLlama-1.1B's group and length (B 1, H 8, KV 1, S
  2048, hd 64, causal): dS rounded once, or split.
* K5 (SSD scan) at Zamba2-2.7B's and Mamba-2-130M's widths: each of W, the
  scaled B rows and the entering state rounded once while the other two
  are split; then all three split (the kernels' choice).

The emulations are the tests' own (tests/test_torch_flash_attention_
variants.py, tests/test_torch_ssd_scan_variants.py).  A few seconds and a
few GB of host memory.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

import test_torch_flash_attention_variants as fa  # noqa: E402
import test_torch_ssd_scan_variants as ssd  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, kernel_bwd  # noqa
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402


def share(got, want, tol):
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


def k3():
    shape = (1, 8, 1, 2048, 2048, 64, True)
    for seed in (11, 12, 13):
        q, k, v, do = fa._inputs(shape, fa.BF16, seed=seed)
        o, lse = kernel.flash_attention_plain(q, k, v, causal=True)
        want, _ = kernel_bwd.bwd_dq_plain(q, k, v, o, lse, do, causal=True)
        for split in (False, True):
            got, _ = fa._emulated_dq(q, k, v, o, lse, do, True, split=split)
            print(f"K3 {shape} seed {seed} dS "
                  f"{'split' if split else 'single'}: "
                  f"{share(got, want, fa.TOL):.3f}", flush=True)


def k5():
    every = ("W", "B", "state")
    for b, l, h, p, n, chunk in ((1, 1024, 4, 64, 64, 256),
                                 (1, 512, 3, 64, 128, 256),
                                 (1, 512, 4, 64, 128, 64)):
        for seed in (0, 1, 2):
            x, dt, A, B, C, D = ssd._inputs(b, l, h, p, n, seed=seed)
            want = ssd_kernel.ssd_scan_plain(x, dt, A, B, C, D, chunk=chunk)
            for single in every + (None,):
                split = tuple(o for o in every if o != single)
                got = ssd._emulated_ssd(x, dt, A, B, C, D, chunk,
                                        split=split)
                what = f"{single} single" if single else "all split"
                print(f"K5 {(b, l, h, p, n, chunk)} seed {seed} {what}: "
                      f"{share(got, want, ssd.TOL):.3f}", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(min(8, torch.get_num_threads()))
    k3()
    k5()
