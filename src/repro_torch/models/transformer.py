"""Decoder-only transformer LM: only what the serving path of the hybrid
and SSM families imports so far (``unembed_matrix``).  The dense LM itself
is still to port (ROADMAP A9)."""

from __future__ import annotations


def unembed_matrix(model, cfg):
    if cfg.tie_embeddings:
        return model.embed.T
    return model.unembed
