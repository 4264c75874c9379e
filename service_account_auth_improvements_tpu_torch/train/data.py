"""Input pipeline: deterministic token batches (port of ``train/data.py``).

A flat token array (pass ``np.memmap`` for corpora bigger than RAM) is cut
into fixed ``[batch, seq]`` windows. Batch order is a pure function of
(seed, epoch, step) — numpy's ``default_rng((seed, epoch))`` permutation,
as in the reference, so the port's batches are the reference's bit for
bit and a resumed run sees the batch sequence it would have seen
uninterrupted. Without a mesh there is one process, and the batch lands on
the device the loop asks for. On a mesh each process is one rank and
reads only the rows of its (dp, fsdp) coordinate; ranks that differ only
in sp or tp read the same rows (the reference reads per host, and a host
there holds every device of its rows).
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


class RowShard:
    """The rows of a global batch of ``batch`` rows that this rank holds
    on ``mesh``: those of its coordinate on the rules' ``batch`` axes,
    counted row-major as the placements split them. Without a mesh, all
    of them."""

    def __init__(self, mesh, batch: int, rules=None):
        self.mesh, self.batch = mesh, batch
        self.index, self.count = 0, 1
        if mesh is None:
            return
        from service_account_auth_improvements_tpu_torch.parallel import (
            sharding,
        )
        from service_account_auth_improvements_tpu_torch.parallel.mesh import (  # noqa: E501
            check_mesh,
        )

        check_mesh(mesh)

        self.places = sharding.logical_sharding(mesh, ("batch", None),
                                                rules)
        for m, p in enumerate(self.places):
            if p.is_shard():
                n = mesh.size(m)
                self.index = self.index * n + mesh.get_coordinate()[m]
                self.count *= n
        if batch % self.count:
            raise ValueError(f"global batch {batch} must divide over "
                             f"{self.count} row shards")

    def mine(self, rows):
        """This rank's part of the global ``rows`` (any sequence)."""
        per = self.batch // self.count
        return rows[self.index * per:(self.index + 1) * per]

    def wrap(self, local: torch.Tensor):
        """This rank's rows as the global batch's ``DTensor`` (without a
        mesh, as they are)."""
        if self.mesh is None:
            return local
        from torch.distributed.tensor import DTensor

        shape = (self.batch, *local.shape[1:])
        return DTensor.from_local(local, self.mesh, self.places,
                                  run_check=False, shape=shape,
                                  stride=(shape[1], 1))

    def shard(self, rows: torch.Tensor):
        """A whole global batch (the same on every rank) → its
        ``DTensor``, keeping only this rank's rows."""
        return self.wrap(self.mine(rows).contiguous())


class TokenBatches:
    """Iterable over [batch, seq] int64 token tensors on ``device`` (the
    card unless ``"cpu"``), or ``(tokens, loss_mask)`` pairs when
    ``eos_id`` is set. With a ``mesh`` each is the global batch as a
    ``DTensor`` split over the rules' ``batch`` axes, whose local block
    (the only rows this rank reads) is its coordinate's share."""

    def __init__(self, tokens, cfg: DataConfig, mesh=None, device=None,
                 rules=None):
        self.tokens = tokens
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        self.n_windows = len(tokens) // cfg.seq
        self.steps_per_epoch = self.n_windows // cfg.batch
        if not self.steps_per_epoch:
            raise ValueError(
                f"{len(tokens)} tokens < one global batch "
                f"({cfg.batch}×{cfg.seq})"
            )
        self._order_cache: tuple[int, np.ndarray] | None = None
        self.rows = RowShard(mesh, cfg.batch, rules)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot take "
                             f"batches on {self.device}")

    def _order(self, epoch: int) -> np.ndarray:
        """Epoch permutation, cached once per epoch."""
        if not self.cfg.shuffle:
            return np.arange(self.n_windows)
        if self._order_cache is None or self._order_cache[0] != epoch:
            rng = np.random.default_rng((self.cfg.seed, epoch))
            self._order_cache = (epoch, rng.permutation(self.n_windows))
        return self._order_cache[1]

    def batch_at(self, step: int) -> torch.Tensor:
        """The step's batch (on a mesh, a ``DTensor`` of which this rank
        reads its block). Pure in ``step`` — the resume contract."""
        epoch, within = divmod(step, self.steps_per_epoch)
        order = self._order(epoch)
        window_ids = order[within * self.cfg.batch:
                           (within + 1) * self.cfg.batch]
        rows = np.stack([
            np.asarray(self.tokens[w * self.cfg.seq:
                                   (w + 1) * self.cfg.seq])
            for w in self.rows.mine(window_ids)
        ]).astype(np.int64)
        return self.rows.wrap(torch.from_numpy(rows).to(self.device))

    def masked_batch_at(self, step: int):
        """``(tokens, loss_mask)`` — an all-ones mask unless ``eos_id`` is
        configured, in which case cross-document targets are zeroed (the
        on-device ``boundary_mask``). Same purity contract as
        ``batch_at``."""
        tokens = self.batch_at(step)
        local = tokens.to_local() if self.mesh is not None else tokens
        mask = torch.ones_like(local, dtype=torch.int32)
        if self.cfg.eos_id is not None:
            mask[:, 1:] = (local[:, :-1] != self.cfg.eos_id).int()
        return tokens, self.rows.wrap(mask)

    def __iter__(self):
        step = 0
        while True:
            if self.cfg.eos_id is None:
                yield self.batch_at(step)
            else:
                yield self.masked_batch_at(step)
            step += 1
