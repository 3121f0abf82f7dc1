from repro_torch.data.federated import ResidencyTracker, partition_iid  # noqa: F401
from repro_torch.data.synthetic import SyntheticImages, SyntheticLM  # noqa: F401
