from repro_torch.models.transformer import (  # noqa: F401
    init_model,
    forward,
    decode_step,
    init_cache,
    prefill,
)
