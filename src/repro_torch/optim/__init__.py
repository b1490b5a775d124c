"""Adam with parameter groups and the paper's LR schedule."""
from .adam import (AdamState, adam_init, adam_update,  # noqa: F401
                   group_for_path, value_and_grad)
from .schedule import linear_warmup_decay  # noqa: F401
