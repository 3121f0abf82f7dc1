"""Event-driven HCN simulator (the port of ``repro.sim``): a deterministic
virtual-clock event queue (``events``), per-device runtime models
(``devices``), mobility-trace replay (``traces``), client selection
(``selection``), the simulation engine
(``engine``) that composes ``wireless.latency`` UL/DL times with compute
times and the real training loop on the card, and the named scenario
registry (``scenarios``).
"""
from repro_torch.sim.devices import DeviceFleet
from repro_torch.sim.engine import SimEngine, Trace
from repro_torch.sim.events import Event, EventQueue
from repro_torch.sim.scenarios import SCENARIOS, get_scenario
from repro_torch.sim.traces import MobilityTrace, generate as generate_trace

__all__ = [
    "DeviceFleet", "SimEngine", "Trace", "Event", "EventQueue",
    "SCENARIOS", "get_scenario", "MobilityTrace", "generate_trace",
]
