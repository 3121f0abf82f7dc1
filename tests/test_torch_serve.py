"""The serving twin, ``launch.serve_batched``: on the reference's weights
and prompts (f32 model math, reduced configs) ``serve`` gives the greedy
tokens of the reference's ``build_prefill_step``/``build_decode_step``
loop, the one ``examples/serve_batched.py`` runs, exactly; the CLI and
``run`` serve every architecture on the CPU.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.launch import serve_batched as SB
from repro_torch.utils.convert import params_from_numpy

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
NAMES = sorted(J_ARCHS)


def _f32(name):
    return dataclasses.replace(j_get(name).reduced(), dtype="float32")


@pytest.mark.parametrize("name", NAMES)
def test_serving_twin_tokens_match_reference(name):
    cfg = _f32(name)
    B, P, NEW = 3, 10, 6
    jp = JT.init_model(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    fe = None
    if cfg.frontend != "none":
        fe = (0.02 * rng.standard_normal((B, cfg.frontend_tokens, JT.frontend_dim(cfg)))
              ).astype(np.float32)
    # the example's loop
    prefill_step = jax.jit(JS.build_prefill_step(cfg))
    decode = jax.jit(JS.build_decode_step(cfg))
    logits, cache = prefill_step(jp, jnp.asarray(prompts),
                                 None if fe is None else jnp.asarray(fe))
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    want = [tok]
    for _ in range(NEW - 1):
        logits, cache = decode(jp, cache, tok)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        want.append(tok)
    want = np.asarray(jnp.concatenate(want, axis=1))

    got, _, _, _ = SB.serve(
        TModelConfig(**dataclasses.asdict(cfg)),
        params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
        torch.from_numpy(prompts).long(),
        None if fe is None else torch.from_numpy(fe), NEW)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", NAMES)
def test_serving_twin_runs_every_arch_on_cpu(name, capsys):
    out = SB.run(name, batch=2, prompt_len=8, new_tokens=4, device="cpu")
    assert out["tokens"].shape == (2, 4) and out["peak_gb"] is None
    assert torch.isfinite(out["logits"].float()).all()
    assert capsys.readouterr().out.splitlines()[-1] == "serve_batched OK"


def test_serve_cli_runs_on_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_batched", "--device", "cpu",
         "--arch", "zamba2-7b", "--batch", "2", "--prompt-len", "8",
         "--new-tokens", "4", "--layers", "3"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[0].startswith("[serve] prefill 2x8: ")
    assert lines[1].startswith("[serve] decoded 4 tokens/seq: ")
    assert lines[-1] == "serve_batched OK"
