"""The placement policy's training side on PyTorch (port of
``controlplane/scheduler/policy/``):

- ``features``: the port's own copy of the pinned ``sched-journal/v1``
  placement-row schema and of the featurizer that turns journal rows
  into fixed-width training examples (numpy and the stdlib);
- ``model``: the masked per-pool scorer on tensors, its seeded init from
  a ``torch.Generator``, and the bridge to the numpy parameter dict the
  checkpoint holds;
- ``train``: the training loop (seeded per-step batches,
  checkpoint/resume through the same ``policy.npz`` the reference writes,
  host syncs gated by ``log_every``) and its CLI.

Serving stays the reference's numpy ``PolicyChooser``: it reads the
``policy.npz`` this trainer writes, with no torch and no JAX.

THIS ``__init__`` IMPORTS NOTHING, as the reference's does. Import
submodules explicitly (``from ...policy import train``).
"""
