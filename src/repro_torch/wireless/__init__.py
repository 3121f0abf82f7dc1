"""The wireless model (the port of ``repro.wireless``, numpy only):
M-QAM rates, the Alg. 2 sub-carrier allocator, the rateless broadcast,
the HCN topology and the FL/HFL latency of the paper's eqs. 14-21."""
from repro_torch.wireless.broadcast import broadcast_latency
from repro_torch.wireless.latency import LatencyParams, fl_latency, hfl_latency
from repro_torch.wireless.qam import exp_integral_e1, optimal_rate_per_subcarrier
from repro_torch.wireless.subcarrier import allocate_subcarriers, min_rate
from repro_torch.wireless.topology import HCNTopology

__all__ = [
    "optimal_rate_per_subcarrier", "exp_integral_e1", "allocate_subcarriers",
    "min_rate", "broadcast_latency", "HCNTopology", "fl_latency",
    "hfl_latency", "LatencyParams",
]
