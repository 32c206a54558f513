"""Training layer: the AdamW recipe, the train step, checkpoint / resume
and the `Trainer` (counterpart of `msvit_tpu/train`)."""

from msvit_tpu_torch.train.checkpoint import (  # noqa: F401
    CheckpointManager,
    restore_checkpoint,
    save_checkpoint,
)
from msvit_tpu_torch.train.loop import (  # noqa: F401
    Optimizer,
    OptState,
    apply_if_finite,
    make_optimizer,
    train_step_fn,
)
from msvit_tpu_torch.train.trainer import Trainer  # noqa: F401
