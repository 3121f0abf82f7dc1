"""The payload part of the wireless latency model (``repro.wireless.
latency``): ``LatencyParams``' model size and ``payload(φ)``, the paper's
analytic bits per transfer that the measured codec streams are held
against. The rest of the model (rates, broadcast, the FL/HFL latency)
comes with the simulator (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

from dataclasses import dataclass

BITS_PER_PARAM = 32.0  # Q̂: f32 values


@dataclass
class LatencyParams:
    model_params: float = 11.2e6  # Q (ResNet18)

    def payload(self, phi: float) -> float:
        """Q·(1 - φ)·Q̂ bits: the paper's accounting, no index stream."""
        return self.model_params * (1.0 - phi) * BITS_PER_PARAM
