"""Training of the port: the train step and hand-written AdamW
(``step.py``), MFU accounting (``mfu.py``), token batches (``data.py``),
checkpoint and resume (``checkpoint.py``), held-out evaluation
(``evaluate.py``), the loop (``loop.py``), LoRA fine-tuning (``lora.py``)
and distillation (``distill.py``)."""

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
from service_account_auth_improvements_tpu_torch.train.lora import (  # noqa: F401
    LoraConfig,
    init_lora_state,
    lora_state_shardings,
    make_lora_train_step,
    merge_lora,
)
from service_account_auth_improvements_tpu_torch.train.distill import (  # noqa: F401,E501
    distill_loss,
    make_distill_step,
)
