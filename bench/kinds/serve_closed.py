"""Closed-loop batch serving through the program's ``launch/serve.py``
``generate``: one client sends a batch of ``batch`` requests of one
prompt length, waits for the answers, and sends the next.

The mix's parameters (``traffic/<mix>.json``):

- ``batch``: requests a batch;
- ``block``: the prompt length of each batch of the repeating block, in
  order: every run and every seed serves the same lengths in the same
  order (the seed draws the prompts' tokens), so a window of fixed length
  holds the same work in every run;
- ``pool_batches``: batches drawn in set-up (the window may not need
  more);
- ``check_requests``: requests the check compares, the longest among
  them; ``check_rows``: rows the reference runs at once;
- ``trace_batches``: batches served under the device timeline after the
  window in a ``--trace 1`` run (one block, so that every length the window
  serves is traced and compared with the window's).

Each request is answered with one token, the prefill's: the program's
``prefill`` returns a zero cache for this family (the JAX package does
too), so tokens decoded after it do not continue the prompt, and a mix
that decodes could not be judged correct.  Prompts are uniform token ids
drawn from the seed; the weights come from ``reference/weights.py``.  The
check runs the float32 reference over each sampled request's prompt and
compares the served token's reference logit with the reference's best
(``reference/plain.gap_of``).
"""

from __future__ import annotations

import gc

import torch

from bench.harness import device_sync, now, seed_generator
from bench.program import load_program, reference_module
from bench.reference import weights as W

PROMPT_STREAM = 2
SAMPLE_STREAM = 4


def plan(traffic: dict, n_batches: int) -> list:
    """Prompt length of each batch: ``block`` repeated."""
    block = [int(length) for length in traffic["block"]]
    return [block[i % len(block)] for i in range(n_batches)]


class Driver:
    """Set-up, window, traced sub-window and check of one serving run.
    ``generate`` may be replaced (the tests plant faults through it)."""

    def __init__(self, run):
        self.run = run
        self.t = run.traffic
        self.B = int(self.t["batch"])
        from repro_torch.launch.serve import generate
        self.generate = generate

    # -- set-up ---------------------------------------------------------
    def setup(self):
        run, dev = self.run, self.run.device
        self.ref = reference_module(run.cfg)
        specs = self.ref.specs(run.cfg["model"])
        self.api = load_program(run.cfg, W.make_weights(specs, run.seed, dev),
                                dev)
        n = int(self.t["pool_batches"])
        self.lengths = plan(self.t, n)
        gen = seed_generator(run.seed, PROMPT_STREAM, dev)
        vocab = run.cfg["model"]["vocab"]
        self.prompts = [torch.randint(0, vocab, (self.B, length),
                                      generator=gen, device=dev)
                        for length in self.lengths]
        # warm every prompt length the mix sends, once
        for length in sorted(set(self.lengths)):
            i = self.lengths.index(length)
            self._serve(i)
        device_sync(dev)

    def _serve(self, i: int):
        tokens = self.prompts[i]
        out = self.generate(self.api, {"tokens": tokens}, tokens.shape[1], 1)
        return out.tokens

    # -- the window -----------------------------------------------------
    def window(self):
        run = self.run
        t_start = now()
        i = 0
        while now() - t_start < run.seconds:
            if i >= len(self.prompts):
                raise RuntimeError("the window outran the pool of prompts: "
                                   "raise pool_batches in the mix")
            t0 = now()
            toks = self._serve(i)
            t1 = now()
            run.records.append({"batch": i, "prompt_len": self.lengths[i],
                                "rows": self.B, "start_s": t0 - t_start,
                                "end_s": t1 - t_start, "ttft_s": t1 - t0,
                                "tokens": toks})
            i += 1
        run.window_s = run.records[-1]["end_s"]
        return i

    def wrappers(self) -> dict:
        """The hand-written kernels' wrappers the timeline brackets, at
        the names their callers look them up by."""
        from repro_torch.kernels.flash_attention import ops as fa_ops
        from repro_torch.kernels.ssd_scan import ops as ssd_ops
        return {(fa_ops, "flash_attention_bhsd"): "K2 flash_attention_bhsd",
                (ssd_ops, "ssd_scan_chunked"): "K5 ssd_scan_chunked"}

    def traced(self, timeline, first: int):
        """``trace_batches`` batches from the pool's ``first`` under
        ``timeline`` (``bench/timeline.py``), each in a span of its own;
        the program's kernel counters over them, and how much longer they
        took than the window's batches of the same lengths (None where the
        window served none of them)."""
        from repro_torch.kernels.flash_attention import kernel as fa_k
        from repro_torch.kernels.ssd_scan import kernel as ssd_k
        n = int(self.t["trace_batches"])
        if first + n > len(self.prompts):
            raise RuntimeError("no prompts left for the traced batches")
        c0 = (fa_k.flash_attention_bhsd.launches,
              ssd_k.ssd_scan_chunked.launches)
        walls = []
        device_sync(self.run.device)
        with timeline:
            for i in range(first, first + n):
                t0 = now()
                with timeline.unit(f"prefill {self.lengths[i]}"):
                    self._serve(i)
                walls.append(now() - t0)
        by_length: dict = {}
        for r in self.run.records:
            by_length.setdefault(r["prompt_len"], []).append(r["ttft_s"])
        pairs = [(wall, sum(by_length[length]) / len(by_length[length]))
                 for wall, length in zip(walls, self.lengths[first:first + n])
                 if length in by_length]
        self.run.counts = {
            "k2_calls": fa_k.flash_attention_bhsd.launches - c0[0],
            "k5_calls": ssd_k.ssd_scan_chunked.launches - c0[1],
            "traced_lengths": self.lengths[first:first + n],
            "traced_rows": self.B,
            "slowdown": (sum(w for w, _ in pairs) / sum(e for _, e in pairs)
                         - 1) if pairs else None}

    def free(self):
        del self.api
        gc.collect()
        if torch.device(self.run.device).type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------
    def sample(self) -> list:
        """(batch, row) of the requests the check compares: the longest
        completed request and others drawn from the seed."""
        recs = self.run.records
        k = min(int(self.t["check_requests"]), len(recs) * self.B)
        gen = seed_generator(self.run.seed, SAMPLE_STREAM)
        longest = max(range(len(recs)), key=lambda j: recs[j]["prompt_len"])
        picks = [(longest, int(torch.randint(0, self.B, (1,),
                                             generator=gen)))]
        order = torch.randperm(len(recs) * self.B, generator=gen).tolist()
        for flat in order:
            if len(picks) >= k:
                break
            pick = (flat // self.B, flat % self.B)
            if pick not in picks:
                picks.append(pick)
        return sorted(picks)

    def reference_logits(self, picks, precision="float32"):
        """The reference's last-position logits [len(picks), vocab] of
        each picked request's prompt (weights drawn again from the seed,
        float32), in blocks of ``check_rows`` rows of one batch."""
        from bench.reference.plain import strict_float32
        run, dev = self.run, self.run.device
        m = run.cfg["model"]
        w = W.make_weights(self.ref.specs(m), run.seed, dev,
                           dtype_override=torch.float32)
        rows_at_once = int(self.t["check_rows"])
        out = []
        with strict_float32():
            by_batch: dict = {}
            for j, r in picks:
                by_batch.setdefault(j, []).append(r)
            for j in sorted(by_batch):
                rows = by_batch[j]
                tokens = self.prompts[run.records[j]["batch"]]
                for r0 in range(0, len(rows), rows_at_once):
                    sel = torch.tensor(rows[r0:r0 + rows_at_once],
                                       device=tokens.device)
                    out.append(self.ref.last_logits(
                        w, m, tokens[sel], precision))
        del w
        return torch.cat(out)

    def served_tokens(self, picks):
        """The first served token of each picked request."""
        return torch.stack([self.run.records[j]["tokens"][r, 0]
                            for j, r in picks])

    def check(self) -> dict:
        from bench.reference.plain import gap_of
        picks = self.sample()
        ref = self.reference_logits(picks)
        self.ref_logits = ref
        gaps = gap_of(ref, self.served_tokens(picks).to(ref.device))
        return {"served_token_gap_max": {
            "value": float(gaps.max()),
            "limit": self.run.limits["served_token_gap_max"]}}

    def control(self) -> dict:
        """The control's reading on the requests the check compared: the
        reference in fp8 put in the program's place, its first token's gap
        in the check's float32 reference."""
        from bench.reference.plain import gap_of
        low = self.reference_logits(self.sample(), precision="fp8")
        gaps = gap_of(self.ref_logits, low.argmax(dim=-1))
        return {"served_token_gap_max": float(gaps.max())}

