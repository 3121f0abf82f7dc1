from repro_torch.checkpoint.msgpack_ckpt import (  # noqa: F401
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
