from repro_torch.core.sparsify import (  # noqa: F401
    dgc_step, omega, topk_mask, threshold_for_phi,
)
from repro_torch.core.hfl import (  # noqa: F401
    HFLState,
    hfl_init,
    make_cluster_train_step,
    make_masked_cluster_train_step,
    make_sync_step,
    serving_params,
)
