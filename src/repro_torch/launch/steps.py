"""The recsys serve and retrieval steps (counterpart of the steps that
``repro.launch.steps`` builds in ``_recsys_serve_cell`` and
``_recsys_retrieval_cell``), as plain functions over port params.

The reference wraps them in ``Cell``s with sharded input stand-ins for its
dry run; that machinery waits for ROADMAP A11. The train step is
``repro_torch.train.trainer.make_train_step`` over ``bce_loss``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.recsys import (RecsysConfig, din_attend, din_head,
                                       mind_retrieval, recsys_logits,
                                       sasrec_encode, xdeepfm_forward)
from repro_torch.sparse.embedding import embedding_lookup

RETRIEVAL_CHUNK = 8000


def recsys_serve_step(params, cfg: RecsysConfig,
                      batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Click probabilities (B,): the sigmoid of ``recsys_logits`` in fp32."""
    return torch.sigmoid(recsys_logits(params, cfg, batch).float())


def retrieval_chunk(n_candidates: int, chunk: int = RETRIEVAL_CHUNK) -> int:
    """The reference's chunk: ``chunk`` if it divides the candidates, else
    the largest divisor below it."""
    if n_candidates % chunk:
        chunk = next(c for c in range(chunk, 0, -1) if n_candidates % c == 0)
    return chunk


def recsys_retrieval_step(params, cfg: RecsysConfig,
                          batch: Dict[str, torch.Tensor], *,
                          chunk: int = RETRIEVAL_CHUNK) -> torch.Tensor:
    """One user against ``cand_ids (C,)`` -> scores (C,).

    MIND and SASRec score every candidate at once (MIND: max over
    interests; SASRec: the last hidden state of ``hist (1, L)`` dotted
    with each candidate's embedding, in fp32). DIN (``hist (1, L)``) and
    xDeepFM (``base_ids (1, F)``, field 0 replaced by ``cand % vocab_0``)
    score ``retrieval_chunk(C, chunk)`` candidates at a time, as the
    reference's ``lax.map`` over its chunk axis does."""
    cand = batch["cand_ids"]
    if cfg.kind == "mind":
        return mind_retrieval(params, cfg, batch["hist"], cand)
    if cfg.kind == "sasrec":
        h = sasrec_encode(params, cfg, batch["hist"])[:, -1]      # (1, D)
        return (embedding_lookup(params["items"], cand) @ h[0]).float()
    if cfg.kind == "din":
        h = embedding_lookup(params["items"], batch["hist"])      # (1, L, D)

        def score(ids):
            t = embedding_lookup(params["items"], ids)[None]      # (1, c, D)
            return din_head(params, din_attend(params, h, t, None), t)[0]
    elif cfg.kind == "xdeepfm":
        v0 = cfg.field_vocabs[0]

        def score(ids):
            full = batch["base_ids"].expand(ids.shape[0], -1).clone()
            full[:, 0] = ids % v0
            return xdeepfm_forward(params, cfg, full)
    else:
        raise ValueError(cfg.kind)
    c = retrieval_chunk(cand.shape[0], chunk)
    return torch.cat([score(ids) for ids in cand.split(c)])


__all__ = ["RETRIEVAL_CHUNK", "recsys_serve_step", "retrieval_chunk",
           "recsys_retrieval_step"]
