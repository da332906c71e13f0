"""Faults planted in a cell's timed path, by name: the check has to come
out not correct with each.  ``plant(name, driver)`` before the driver's
set-up.  The tests plant them on the CPU; ``calibrate.py --fault`` reads
them on the chip at the cell's own size."""

from __future__ import annotations

import torch


def _serve_fp8_control(drv):
    """The control in the program's place: each request's token is the
    fp8 reference's best."""
    from repro_torch.launch.serve import Generation

    from bench.program import reference_module
    from bench.reference import weights as W
    ref = reference_module(drv.run.cfg)
    m = drv.run.cfg["model"]
    state = {}

    def generate(api, batch, prompt_len, gen):
        if "w" not in state:
            state["w"] = W.make_weights(ref.specs(m), drv.run.seed,
                                        drv.run.device,
                                        dtype_override=torch.float32)
        logits = ref.last_logits(state["w"], m, batch["tokens"],
                                 precision="fp8")
        return Generation(logits.argmax(-1)[:, None], logits, 0.0, 0.0)
    drv.generate = generate


def _serve_token_altered(drv):
    """Each served token replaced by the next id where it is produced."""
    inner = drv.generate

    def generate(api, batch, prompt_len, gen):
        out = inner(api, batch, prompt_len, gen)
        out.tokens[:, 0] = (out.tokens[:, 0] + 1) % drv.run.cfg["model"][
            "vocab"]
        return out
    drv.generate = generate


def _serve_half_batch(drv):
    """Only the first half of each batch is served; the rest get its
    answers."""
    inner = drv.generate

    def generate(api, batch, prompt_len, gen):
        half = batch["tokens"].shape[0] // 2
        out = inner(api, {"tokens": batch["tokens"][:half]}, prompt_len, gen)
        out.tokens = torch.cat([out.tokens, out.tokens])
        return out
    drv.generate = generate


def _train_state_unchanged(drv):
    """The step computes its loss and leaves the model and the optimizer
    state as they were."""
    def wrap(step):
        def unchanged(params, state, batch):
            with torch.no_grad():
                loss = drv.api.loss(batch)
            return params, state, {"loss": loss}
        return unchanged
    drv.wrap = wrap


def _train_half_batch(drv):
    """The step takes the first half of each batch: the mean over the
    rest."""
    def wrap(step):
        def half(params, state, batch):
            n = batch["tokens"].shape[0] // 2
            return step(params, state, {k: v[:n] for k, v in batch.items()})
        return half
    drv.wrap = wrap


def _train_labels_altered(drv):
    """Each label replaced by the next id where the step receives it."""
    def wrap(step):
        def altered(params, state, batch):
            v = drv.run.cfg["model"]["vocab"]
            return step(params, state, {"tokens": batch["tokens"],
                                        "labels": (batch["labels"] + 1) % v})
        return altered
    drv.wrap = wrap


FAULTS = {
    "serve_closed": {"fp8_control": _serve_fp8_control,
                     "token_altered": _serve_token_altered,
                     "half_batch": _serve_half_batch},
    "train_steps": {"state_unchanged": _train_state_unchanged,
                    "half_batch": _train_half_batch,
                    "labels_altered": _train_labels_altered},
}


def plant(kind: str, name: str, drv) -> None:
    FAULTS[kind][name](drv)
