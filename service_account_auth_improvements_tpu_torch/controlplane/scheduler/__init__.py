"""The scheduler's learned-placement trainer (``policy/``), ported. The
scheduler itself (inventory, best-fit placement, queue, preemption) is
stdlib code of the control plane and has no port. This ``__init__``
imports nothing."""
