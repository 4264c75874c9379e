"""Knowledge distillation (port of ``train/distill.py``): train a student
against a frozen teacher.

The loss mixes soft targets with hard labels (Hinton et al.):
``alpha · T² · KL(p_T^T ‖ p_S^T) + (1-alpha) · CE(student, labels)``; the
T² factor keeps soft-target gradient magnitudes comparable across
temperatures. The teacher's backbone runs under ``torch.no_grad()`` (the
reference's ``stop_gradient``): it builds no graph, so the backward never
recomputes it, and only its last hidden states are kept for the loss.

This is how the draft models speculative decoding wants
(``models/speculative.py``) get made: distill the big target into a small
student with the same vocabulary, then serve it with
``--draft-checkpoint-dir``.

On a mesh the student is a sharded ``TrainState`` and the teacher's
params ``DTensor``s laid out by the rules; both forwards run in the
mesh's region (the teacher's weights gathered at use, under
``no_grad``), each rank's share of the loss is summed over the
data-parallel ranks as ``next_token_loss``'s is, and the update is
``train.step.sharded_update``. With the vocabulary split over tp each
chunk's logits are gathered over it for the softmaxes.
"""

from __future__ import annotations

import torch

from service_account_auth_improvements_tpu_torch.models import llama
from service_account_auth_improvements_tpu_torch.parallel import sharding
from service_account_auth_improvements_tpu_torch.parallel.mesh import (
    check_mesh,
    use_mesh,
)
from service_account_auth_improvements_tpu_torch.train.step import (
    AdamW,
    TrainState,
    _map,
    global_norm,
    make_optimizer,
    sharded_update,
)
from service_account_auth_improvements_tpu_torch.utils.tree import (
    value_and_grad,
)


def _distill_chunk(cfg_s, x_s, x_t, head_s, head_t, targets,
                   temperature: float, region=sharding.NO_REGION):
    """(ce [b, c], kl [b, c]) for one sequence chunk. The logits are
    ``_nll``'s: compute-dtype operands multiplied in f32 (the reference's
    ``preferred_element_type=float32``); the target logit is a gather,
    which gives the reference's one-hot contraction exactly. Vocab
    shards' logits are gathered over tp (``x_s`` has taken
    ``region.vocab_copy``)."""
    logits_s = region.vocab_gather(x_s.float() @ head_s.float())
    logits_t = region.vocab_gather(x_t.float() @ head_t.float())

    logz = torch.logsumexp(logits_s, dim=-1)
    ce = logz - logits_s.gather(-1, targets[..., None])[..., 0]

    lsT = logits_s / temperature
    lsT = lsT - torch.logsumexp(lsT, dim=-1, keepdim=True)
    ltT = logits_t / temperature
    ltT = ltT - torch.logsumexp(ltT, dim=-1, keepdim=True)
    kl = torch.sum(torch.exp(ltT) * (ltT - lsT), dim=-1)
    return ce, kl


def _check_vocab(cfg_s, cfg_t) -> None:
    # the KL runs over the shared vocab axis
    if cfg_s.vocab_size != cfg_t.vocab_size:
        raise ValueError("student/teacher vocabularies must match")


def distill_loss(cfg_s: llama.LlamaConfig, cfg_t: llama.LlamaConfig,
                 student_params, teacher_params, tokens, mask,
                 temperature: float = 2.0, alpha: float = 0.5):
    """Mixed soft/hard next-token loss; returns (loss, metrics).

    Mirrors ``next_token_loss``'s contracts: ``mask`` doubles as the
    backbone validity mask (padding neither routes through MoE experts
    nor counts in the loss), the student's MoE load-balance aux is
    included, and with ``cfg_s.loss_chunk`` the vocab projections and the
    soft and hard terms run ``loss_chunk`` positions at a time under
    ``torch.utils.checkpoint`` (``llama.scan_seq_chunks``): the full [b,
    s, vocab] f32 tensors never exist. The teacher's logits are part of
    each chunk and are recomputed with it in the backward pass, as the
    reference's ``jax.checkpoint`` recomputes them."""
    _check_vocab(cfg_s, cfg_t)
    region = sharding.local_region()
    cdt_s, cdt_t = llama.dtype_of(cfg_s.dtype), llama.dtype_of(cfg_t.dtype)
    x_s, aux_s = llama._backbone(cfg_s, student_params, tokens,
                                 token_mask=mask)
    with torch.no_grad():
        x_t, _ = llama._backbone(cfg_t, teacher_params, tokens,
                                 token_mask=mask)
        head_t = region.param(teacher_params["lm_head"],
                              ("embed", "vocab")).detach().to(cdt_t)
    trim, targets, w, count = llama.next_token_targets(cfg_s, region,
                                                       tokens, mask)
    if trim:
        x_s = x_s[:, :-1]
        x_t = x_t[:, :-1]
    x_s = region.vocab_copy(x_s)
    head_s = region.param(student_params["lm_head"],
                          ("embed", "vocab")).to(cdt_s)

    def chunk_fn(a, bb, tc):
        return _distill_chunk(cfg_s, a, bb, head_s, head_t, tc,
                              temperature, region)

    if cfg_s.loss_chunk:
        ce, kl = llama.scan_seq_chunks(
            chunk_fn, min(cfg_s.loss_chunk, x_s.shape[1]), x_s, x_t,
            targets,
        )
    else:
        # unchunked: one whole-sequence pass with its intermediates saved
        # (no recompute), matching next_token_loss's branch
        ce, kl = chunk_fn(x_s, x_t, targets)

    denom = region.batch_sum(count).clamp_min(1.0)
    hard = torch.sum(ce * w) / denom
    soft = torch.sum(kl * w) / denom
    loss = alpha * temperature**2 * soft + (1.0 - alpha) * hard
    if cfg_s.moe_experts:
        shares = region.n_batch * region.sizes["sp"]
        loss = loss + cfg_s.moe_aux_weight * (aux_s / shares if shares > 1
                                              else aux_s)
    loss, hard, soft = (region.data_sum(t) for t in (loss, hard, soft))
    return loss, {"loss": loss, "hard_loss": hard, "kl": soft}


def make_distill_step(cfg_s: llama.LlamaConfig, cfg_t: llama.LlamaConfig,
                      optimizer: AdamW | None = None, mesh=None, rules=None,
                      temperature: float = 2.0, alpha: float = 0.5):
    """Return ``step(state, teacher_params, tokens, mask) -> (state,
    metrics)``. ``state`` holds the student (updated in place, as
    ``make_train_step`` updates); the teacher is a plain argument that
    comes back untouched. Metrics are ``distill_loss``'s (detached) and
    the student's pre-clip ``grad_norm``. With a ``mesh`` the student
    state is sharded (``train.step.shard_state``), the teacher's params
    laid out by the rules (``parallel.sharding.tree_distribute``) and
    the batch as ``make_train_step`` takes it."""
    _check_vocab(cfg_s, cfg_t)
    optimizer = optimizer or make_optimizer()

    def loss_fn(student_params, teacher_params, tokens, mask):
        return distill_loss(cfg_s, cfg_t, student_params, teacher_params,
                            tokens, mask, temperature, alpha)

    def step(state: TrainState, teacher_params, tokens, mask):
        teacher = _map(torch.Tensor.detach, teacher_params)
        (_, metrics), grads = value_and_grad(
            loss_fn, state.params, teacher, tokens, mask, has_aux=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = gnorm = global_norm(grads)
        params, opt_state = optimizer.apply(grads, state.opt_state,
                                            state.params, gnorm)
        return TrainState(state.step + 1, params, opt_state), metrics

    if mesh is None:
        return step
    check_mesh(mesh)
    axes = llama.logical_axes(cfg_s)
    local = sharding.to_local

    def sharded_step(state: TrainState, teacher_params, tokens, mask):
        params = _map(local, state.params)
        teacher = _map(lambda t: local(t).detach(), teacher_params)
        with use_mesh(mesh, rules):
            region = sharding.local_region()
            (_, metrics), grads = value_and_grad(
                loss_fn, params, teacher, local(tokens), local(mask),
                has_aux=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        state, metrics["grad_norm"] = sharded_update(
            region, axes, optimizer, state, params, grads)
        return state, metrics

    return sharded_step
