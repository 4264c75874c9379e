"""Input pipeline: deterministic token batches (port of ``train/data.py``).

A flat token array (pass ``np.memmap`` for corpora bigger than RAM) is cut
into fixed ``[batch, seq]`` windows. Batch order is a pure function of
(seed, epoch, step) — numpy's ``default_rng((seed, epoch))`` permutation,
as in the reference, so the port's batches are the reference's bit for
bit and a resumed run sees the batch sequence it would have seen
uninterrupted. Without a mesh there is one process, and the batch lands on
the device the loop asks for; a mesh (per-process slices of a sharded
global batch) waits for the parallel slice (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from service_account_auth_improvements_tpu_torch.utils.device import (
    resolve_device,
)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int          # GLOBAL batch; the trailing sub-batch epoch
    seq: int            # remainder is dropped
    shuffle: bool = True
    seed: int = 0
    # Document separator id for packed corpora (``pack_documents``).
    # When set, batches come with a loss mask that zeroes the
    # cross-document target.
    eos_id: int | None = None


def pack_documents(docs, eos_id: int, dtype=np.int32) -> np.ndarray:
    """Concatenate token sequences into one flat stream with ``eos_id``
    after each document — the packed-pretraining layout ``TokenBatches``
    windows over."""
    out = np.empty(sum(len(d) + 1 for d in docs), dtype=dtype)
    i = 0
    for d in docs:
        n = len(d)
        out[i:i + n] = np.asarray(d, dtype=dtype)
        out[i + n] = eos_id
        i += n + 1
    return out


def boundary_mask(tokens: np.ndarray, eos_id: int) -> np.ndarray:
    """Loss mask for packed windows: a position whose PREVIOUS token is
    ``eos_id`` starts a new document — predicting it is masked out (the
    EOS targets themselves stay on). Shape-preserving, float32 in
    {0, 1}."""
    mask = np.ones_like(tokens, dtype=np.float32)
    mask[:, 1:] = np.where(tokens[:, :-1] == eos_id, 0.0, 1.0)
    return mask


class TokenBatches:
    """Iterable over [batch, seq] int64 token tensors on ``device`` (the
    card unless ``"cpu"``), or ``(tokens, loss_mask)`` pairs when
    ``eos_id`` is set."""

    def __init__(self, tokens, cfg: DataConfig, mesh=None, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "sharded batches (mesh) are not ported yet (ROADMAP queue "
                "1, item 8, \"parallel\")")
        self.tokens = tokens
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_windows = len(tokens) // cfg.seq
        self.steps_per_epoch = self.n_windows // cfg.batch
        if not self.steps_per_epoch:
            raise ValueError(
                f"{len(tokens)} tokens < one global batch "
                f"({cfg.batch}×{cfg.seq})"
            )
        self._order_cache: tuple[int, np.ndarray] | None = None

    def _order(self, epoch: int) -> np.ndarray:
        """Epoch permutation, cached once per epoch."""
        if not self.cfg.shuffle:
            return np.arange(self.n_windows)
        if self._order_cache is None or self._order_cache[0] != epoch:
            rng = np.random.default_rng((self.cfg.seed, epoch))
            self._order_cache = (epoch, rng.permutation(self.n_windows))
        return self._order_cache[1]

    def batch_at(self, step: int) -> torch.Tensor:
        """The step's batch. Pure in ``step`` — the resume contract."""
        epoch, within = divmod(step, self.steps_per_epoch)
        order = self._order(epoch)
        window_ids = order[within * self.cfg.batch:
                           (within + 1) * self.cfg.batch]
        rows = np.stack([
            np.asarray(self.tokens[w * self.cfg.seq:
                                   (w + 1) * self.cfg.seq])
            for w in window_ids
        ]).astype(np.int64)
        return torch.from_numpy(rows).to(self.device)

    def masked_batch_at(self, step: int):
        """``(tokens, loss_mask)`` — an all-ones mask unless ``eos_id`` is
        configured, in which case cross-document targets are zeroed (the
        on-device ``boundary_mask``). Same purity contract as
        ``batch_at``."""
        tokens = self.batch_at(step)
        mask = torch.ones_like(tokens, dtype=torch.int32)
        if self.cfg.eos_id is not None:
            mask[:, 1:] = (tokens[:, :-1] != self.cfg.eos_id).int()
        return tokens, mask

    def __iter__(self):
        step = 0
        while True:
            if self.cfg.eos_id is None:
                yield self.batch_at(step)
            else:
                yield self.masked_batch_at(step)
            step += 1
