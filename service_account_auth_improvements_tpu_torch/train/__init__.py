"""Training of the port: the train step and hand-written AdamW
(``step.py``), MFU accounting (``mfu.py``), token batches (``data.py``),
checkpoint and resume (``checkpoint.py``), held-out evaluation
(``evaluate.py``) and the loop (``loop.py``). LoRA and distillation are
ROADMAP queue 1 item 7."""

from service_account_auth_improvements_tpu_torch.train.step import (  # noqa: F401
    TrainState,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
    init_train_state,
)
from service_account_auth_improvements_tpu_torch.train.mfu import (  # noqa: F401
    chip_peak_flops,
    mfu,
)
# the ``evaluate`` function is not re-exported: it would shadow the
# ``train.evaluate`` submodule; use ``train.evaluate.evaluate(...)``
from service_account_auth_improvements_tpu_torch.train.evaluate import (  # noqa: F401
    make_eval_step,
)
