"""Architecture registry: ``get_config("<arch-id>")`` / ``--arch <id>``.

Holds the architectures the port runs so far (the dense transformer path).
"""
from repro_torch.configs.base import (  # noqa: F401
    HFLConfig, ModelConfig, SimConfig, TierConfig, parse_tiers_spec,
)
from repro_torch.configs.olmo_1b import CONFIG as _olmo

ARCHS = {c.name: c for c in (_olmo,)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port supports "
                       f"{sorted(ARCHS)} (ROADMAP Queue 1 item 15 ports "
                       "the other families)")
    return ARCHS[name]
