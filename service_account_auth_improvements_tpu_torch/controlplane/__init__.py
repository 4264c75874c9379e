"""The control plane's accelerator-facing parts, ported to the H100 (the
counterpart of ``controlplane/``): the GPU binding (``gpu.py``) and the
placement-policy trainer (``scheduler/policy/``). The rest of the control
plane (API client, reconcilers, scheduler) is stdlib code that runs no
model and has no port. This ``__init__`` imports nothing."""
