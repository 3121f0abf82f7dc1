from repro_torch.optim.schedules import constant_lr, warmup_step_decay  # noqa: F401
from repro_torch.optim.sgd import SGDM, AdamW  # noqa: F401
