"""Held-out evaluation: masked next-token loss and perplexity (port of
``train/evaluate.py``).

One forward per batch under ``torch.inference_mode()`` (no grads, no
optimizer state, no rematerialisation: flash attention runs its forward
kernel once per layer). Token-weighted accounting: batches contribute by
their real (unmasked) token counts, so ragged final batches and padding do
not skew the mean. The sums stay on the device and are read once, after
the last batch. On a mesh every rank runs the step on its rows and the
sums are global, the same on every rank.
"""

from __future__ import annotations

import math

import torch

from service_account_auth_improvements_tpu_torch.models import llama
from service_account_auth_improvements_tpu_torch.parallel import sharding
from service_account_auth_improvements_tpu_torch.parallel.mesh import (
    check_mesh,
    use_mesh,
)
from service_account_auth_improvements_tpu_torch.utils.device import (
    resolve_device,
)
from service_account_auth_improvements_tpu_torch.utils.tree import tree_map


def make_eval_step(cfg: llama.LlamaConfig, mesh=None, rules=None,
                   packed: bool = False):
    """Return ``eval_step(params, tokens, mask) -> (nll_sum, n)``: the
    summed next-token NLL over unmasked target positions and their count,
    as f32 tensors on the batch's device; the caller aggregates across
    batches. ``packed=True`` treats the mask as a pure loss mask (packed
    corpus; see ``make_train_step``). With a ``mesh`` the params are the
    sharded state's (``DTensor``s) and the batch a ``DTensor`` split over
    (dp, fsdp) or this rank's rows; the sums are global."""

    def step(params, tokens, mask, region=None):
        n = mask[:, 1:].float().sum()
        if region is not None:
            n = region.batch_sum(n)
        # pure CE: a load-balance term is a training regulariser and does
        # not belong in perplexity
        loss = llama.next_token_loss(
            cfg, params, tokens, mask, include_aux=False,
            token_mask=None if packed else mask)
        return loss * n, n

    if mesh is None:
        return torch.inference_mode()(step)
    check_mesh(mesh)
    local = sharding.to_local

    @torch.inference_mode()
    def sharded_step(params, tokens, mask):
        with use_mesh(mesh, rules):
            return step(tree_map(local, params), local(tokens), local(mask),
                        sharding.local_region())

    return sharded_step


def evaluate(cfg: llama.LlamaConfig, params, batches, mesh=None, step=None,
             packed: bool = False, device=None, rules=None) -> dict:
    """Aggregate eval over an iterable of ``(tokens, mask)`` (or bare
    ``tokens``) batches on ``device`` (the card unless ``"cpu"``, where
    ``params`` must live) → ``{"loss", "perplexity", "tokens"}``. On a
    ``mesh`` a batch is a pair of ``DTensor``s split over (dp, fsdp) (as
    ``fit`` lays them out) or this rank's rows.

    Pass a prebuilt ``step`` (``make_eval_step``) when calling
    periodically from a training loop. Raises on an empty or exhausted
    ``batches`` iterable rather than reporting a perfect-looking 0-token
    score."""
    dev = resolve_device(device)
    pdev = params["tok_embed"].device
    if pdev.type != dev.type:
        raise ValueError(f"params are on {pdev}, but device {dev} was "
                         "asked for")
    step = step or make_eval_step(cfg, mesh=mesh, rules=rules,
                                  packed=packed)
    total = count = None
    for batch in batches:
        if isinstance(batch, (tuple, list)):
            tokens, mask = batch
        else:
            tokens, mask = batch, None
        if not sharding.is_dtensor(tokens):
            tokens = torch.as_tensor(tokens, dtype=torch.long, device=pdev)
            mask = (torch.ones_like(tokens, dtype=torch.int32)
                    if mask is None else torch.as_tensor(mask, device=pdev))
        s, n = step(params, tokens, mask)
        total = s if total is None else total + s
        count = n if count is None else count + n
    # the one host sync, after the last batch
    total, count = (torch.stack([total, count]).tolist()
                    if count is not None else (0.0, 0.0))
    if count == 0:
        raise ValueError("evaluate() saw no tokens — empty or already-"
                         "exhausted batches iterable?")
    loss = total / count
    return {"loss": loss, "perplexity": math.exp(min(loss, 80.0)),
            "tokens": int(count)}
