"""Training: losses, metrics, the train state and its checkpoints."""

from gammagl_tpu_torch.train.metrics import (  # noqa: F401
    accuracy,
    macro_f1,
    micro_f1,
    semi_supervised_loss,
)
from gammagl_tpu_torch.train.state import (  # noqa: F401
    TrainState,
    load_checkpoint,
    load_checkpoint_sharded,
    save_checkpoint,
    save_checkpoint_sharded,
)

__all__ = ["accuracy", "micro_f1", "macro_f1", "semi_supervised_loss",
           "TrainState", "save_checkpoint", "load_checkpoint",
           "save_checkpoint_sharded", "load_checkpoint_sharded"]
