from repro_torch.utils import flatten  # noqa: F401
from repro_torch.utils.tree import (  # noqa: F401
    global_norm,
    param_count,
    param_bytes,
    tree_add,
    tree_scale,
    tree_zeros_like,
    flatten_to_vector,
    unflatten_from_vector,
)
