"""The train CLI on the new families, the port against the reference CLI:
``launch.train`` at ``--tiers 2x1:H=2 --steps 2`` (reduced configs in f32
model math, the reference's init carried across). The per-step losses and
the eval loss of mamba2-780m, zamba2-7b, deepseek-v2-236b and dbrx-132b
at rtol 1e-4 (measured at most 8e-7), with the token stream equal; and
musicgen-medium's token stream and frontend draws (one seed from the
stream's rng per batch, as the reference seeds its key) equal to the
reference's. Its frontend embeddings are a torch.Generator's, not jax's
threefry numbers, so its losses are only held finite.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get
from repro.launch import train as JTR
from repro.models import transformer as JT
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.launch import train as TTR
from repro_torch.utils.convert import params_from_numpy

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

ARGV = ["--tiers", "2x1:H=2", "--steps", "2", "--batch-per-mu", "2", "--seq", "16",
        "--log-every", "1"]


def _patch_f32(monkeypatch):
    """Both CLIs build f32 configs and the port starts from the reference's
    init. Returns what each side drew: every ``SyntheticLM.sample`` batch
    and the seed of every frontend draw."""
    from repro.data import SyntheticLM as JLM
    from repro_torch.data import SyntheticLM as TLM

    seen = {"ref": [], "port": [], "ref_fe": [], "port_fe": []}
    real = j_get
    monkeypatch.setattr(JTR, "get_config",
                        lambda n: dataclasses.replace(real(n), dtype="float32"))
    monkeypatch.setattr(TTR, "get_config", lambda n: TModelConfig(
        **dataclasses.asdict(dataclasses.replace(real(n), dtype="float32"))))

    def port_init(gen, cfg, device=None):
        jcfg = dataclasses.replace(real(cfg.name.replace("-smoke", "")).reduced(),
                                   dtype="float32")
        # the reference's fields alike (the port's own MoE and YaRN fields beside them)
        jd = dataclasses.asdict(jcfg)
        assert {k: v for k, v in dataclasses.asdict(cfg).items() if k in jd} == jd
        return params_from_numpy(
            jax.tree.map(np.asarray, JT.init_model(jax.random.PRNGKey(0), jcfg)), device)

    monkeypatch.setattr(TTR, "init_model", port_init)
    for cls, side in ((JLM, "ref"), (TLM, "port")):
        def sample(self, *a, _real=cls.sample, _side=side, **k):
            out = _real(self, *a, **k)
            seen[_side].append(np.array(out))
            return out
        monkeypatch.setattr(cls, "sample", sample)
    real_jfe, real_tfe = JTR.fake_frontend_embeds, TTR.fake_frontend_embeds

    def jfe(key, cfg, batch):
        seen["ref_fe"].append((int(np.asarray(key)[-1]), batch))
        return real_jfe(key, cfg, batch)

    def tfe(gen, cfg, batch):
        seen["port_fe"].append((gen.initial_seed(), batch))
        out = real_tfe(gen, cfg, batch)
        assert out.dtype == torch.float32
        return out

    monkeypatch.setattr(JTR, "fake_frontend_embeds", jfe)
    monkeypatch.setattr(TTR, "fake_frontend_embeds", tfe)
    return seen


def _check_streams(seen):
    assert len(seen["port"]) == len(seen["ref"]) >= 3  # 2 batches + eval
    for a, b in zip(seen["port"], seen["ref"]):
        np.testing.assert_array_equal(a, b)
    assert seen["port_fe"] == seen["ref_fe"]


@pytest.mark.parametrize("name", ["mamba2-780m", "zamba2-7b", "deepseek-v2-236b",
                                  "dbrx-132b"])
def test_train_cli_losses_match_reference(name, monkeypatch):
    seen = _patch_f32(monkeypatch)
    argv = ARGV + ["--arch", name]
    jhist, jeval = JTR.main(argv)
    thist, teval = TTR.main(argv + ["--device", "cpu"])
    assert len(thist) == len(jhist) == 2
    np.testing.assert_allclose(thist, jhist, rtol=1e-4)
    np.testing.assert_allclose(teval, jeval, rtol=1e-4)
    _check_streams(seen)
    assert seen["port_fe"] == []


def test_train_cli_frontend_batches_follow_the_reference_stream(monkeypatch):
    seen = _patch_f32(monkeypatch)
    argv = ARGV + ["--arch", "musicgen-medium"]
    jhist, _ = JTR.main(argv)
    thist, teval = TTR.main(argv + ["--device", "cpu"])
    assert np.isfinite(thist).all() and np.isfinite(teval) and len(thist) == 2
    _check_streams(seen)
    # one draw per batch of 2 clusters x 2 rows, then the eval's (seed 7)
    assert [b for _, b in seen["port_fe"]] == [4, 4, 32]
    assert seen["port_fe"][-1][0] == 7
