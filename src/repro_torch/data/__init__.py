from repro_torch.data.federated import (  # noqa: F401
    ResidencyTracker, partition_dirichlet, partition_iid, partition_label_sorted,
)
from repro_torch.data.pipeline import FederatedBatcher, cluster_batches  # noqa: F401
from repro_torch.data.synthetic import SyntheticImages, SyntheticLM  # noqa: F401
