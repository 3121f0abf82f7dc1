"""Architecture registry: ``get_config("<arch-id>")`` / ``--arch <id>``."""
from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES, HFLConfig, ModelConfig, ShapeConfig, SimConfig, TierConfig,
    parse_tiers_spec,
)
from repro_torch.configs.dbrx_132b import CONFIG as _dbrx
from repro_torch.configs.deepseek_v2_236b import CONFIG as _deepseek
from repro_torch.configs.deepseek_v2_lite import CONFIG as _deepseek_lite
from repro_torch.configs.granite_34b import CONFIG as _granite
from repro_torch.configs.h2o_danube3_4b import CONFIG as _danube
from repro_torch.configs.llava_next_34b import CONFIG as _llava
from repro_torch.configs.mamba2_780m import CONFIG as _mamba2
from repro_torch.configs.musicgen_medium import CONFIG as _musicgen
from repro_torch.configs.olmo_1b import CONFIG as _olmo
from repro_torch.configs.starcoder2_3b import CONFIG as _starcoder2
from repro_torch.configs.zamba2_7b import CONFIG as _zamba2

ARCHS = {
    c.name: c
    for c in (
        _zamba2, _olmo, _granite, _deepseek, _danube,
        _musicgen, _mamba2, _dbrx, _starcoder2, _llava, _deepseek_lite,
    )
}
# the port's own entries, which the reference's registry does not have
PORT_ONLY = ("deepseek-v2-lite",)


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in INPUT_SHAPES:
        raise KeyError(f"unknown shape {name!r}; choose from {sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[name]
