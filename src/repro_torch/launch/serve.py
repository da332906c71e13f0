"""Batched serving: prefill + greedy decode loop with a cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_2_7b \
      --smoke --batch 4 --prompt-len 32 --gen 16

Runs on the CUDA device (and raises without one); a caller may pass
``main(argv, device="cpu")``, as the tests do.  The kernels run when the
config asks for them (``attn_impl="flash"``, set with
``dataclasses.replace``), as in the reference; the CLI serves the config as
published.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs.base import ShapeCell, get_config
from repro_torch.device import resolve_device
from repro_torch.models.api import ModelApi, build


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor            # [batch, gen] greedy tokens (int64)
    prefill_logits: torch.Tensor    # [batch, vocab] of the last position
    prefill_s: float
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate(api: ModelApi, tokens: torch.Tensor, prompt_len: int,
             gen: int) -> Generation:
    """The reference's serving loop: prefill over all ``tokens`` (prompt +
    generation region, which sizes the cache), then ``gen - 1`` greedy
    decode steps at positions ``prompt_len + i``."""
    device = tokens.device
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = api.prefill({"tokens": tokens})
    prefill_logits = logits
    tok = torch.argmax(logits, dim=-1)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    outs = [tok]
    t1 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = api.decode(cache, tok, prompt_len + i)
        tok = torch.argmax(logits, dim=-1)
        outs.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t1
    return Generation(torch.stack(outs, 1), prefill_logits, t_prefill,
                      t_decode)


def main(argv=None, *, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama_1_1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--mesh", default="none", choices=["none", "host"])
    args = ap.parse_args(argv)

    device = resolve_device(device)
    if args.mesh == "host":
        raise NotImplementedError(
            "--mesh host needs distributed/, not ported to repro_torch yet "
            "(ROADMAP A11)")
    cfg = get_config(args.arch, smoke=args.smoke)
    api = build(cfg, device=device,
                generator=torch.Generator(device=device).manual_seed(0))

    # prefill cache sized for prompt + generation; only the first
    # prompt_len tokens are "real", the rest are written during decode
    total = args.prompt_len + args.gen
    shape = ShapeCell("serve", "prefill", total, args.batch)
    batch = api.make_batch(torch.Generator(device=device).manual_seed(1),
                           shape)
    out = generate(api, batch["tokens"][:, :total], args.prompt_len,
                   args.gen)

    toks_per_s = args.batch * (args.gen - 1) / max(out.decode_s, 1e-9)
    print(f"prefill: {out.prefill_s:.3f}s for {args.batch}x{total}")
    print(f"decode:  {out.decode_s:.3f}s for {args.gen - 1} steps "
          f"({toks_per_s:.1f} tok/s)")
    gen = out.tokens.cpu().numpy()
    print("generated tokens [batch 0]:", gen[0][:16])
    return gen


if __name__ == "__main__":
    main()
