"""The plain references agree with the port at a tiny size on the CPU, and
the LM cells' control (the reference with float8 products) fails their
limits.  The reference imports nothing of the port; these tests hand both
sides the same weights."""
import json

import numpy as np
import pytest
import torch

from _tiny import ROOT
from hflbench import gen
from hflbench.reference import faithful as rf
from hflbench.reference import lm as rl
from hflbench.reference import omega

TINY_LM = {**json.loads((ROOT / "hflbench/configs/olmo-1b.json").read_text())["model"],
           **json.loads((ROOT / "hflbench/configs/olmo-1b.json").read_text())["tiny"]["model"]}


def _port_cfg(m):
    import dataclasses

    from repro_torch.configs import get_config
    from hflbench.drivers.lm_hfl import MODEL_KEYS

    return dataclasses.replace(get_config(m["name"]), **{k: m[k] for k in MODEL_KEYS})


def test_weights_have_the_ports_tree_layout():
    from repro_torch.models.transformer import init_model

    m = {**TINY_LM, "dtype": "bfloat16"}
    ours = rl.named_leaves(gen.lm_weights(m, 3, "cpu"))
    port = rl.named_leaves(init_model(torch.Generator(), _port_cfg(m), device="meta"))
    assert [(n, tuple(t.shape), t.dtype) for n, t in ours] == \
           [(n, tuple(t.shape), t.dtype) for n, t in port]


def test_lm_loss_and_gradient_match_the_port():
    from repro_torch.launch.steps import make_loss_fn

    w = gen.lm_weights(TINY_LM, 5, "cpu")
    tok = torch.randint(0, TINY_LM["vocab_size"], (3, 24), generator=torch.Generator().manual_seed(1))
    names, leaves = zip(*rl.named_leaves(w))
    a = [t.clone().requires_grad_(True) for t in leaves]
    b = [t.clone().requires_grad_(True) for t in leaves]
    lp = make_loss_fn(_port_cfg(TINY_LM))(rl._unflatten(names, a), {"tokens": tok})[0]
    lr = rl.lm_loss(rl._unflatten(names, b), tok, TINY_LM)
    assert abs(float(lp) - float(lr)) < 1e-5
    for ga, gb in zip(torch.autograd.grad(lp, a, allow_unused=True),
                      torch.autograd.grad(lr, b, allow_unused=True)):
        if ga is not None and gb is not None:
            assert torch.allclose(ga, gb, rtol=1e-4, atol=1e-6)


def test_resnet_matches_the_port():
    from repro_torch.models.resnet import resnet18_forward

    m = {"width": 0.125, "num_classes": 10, "image": [32, 32, 3]}
    p = gen.resnet_weights(m, 2, "cpu")
    bn = {k: {"mean": torch.zeros_like(v["scale"]), "var": torch.ones_like(v["scale"])}
          for k, v in p.items() if isinstance(v, dict)}
    x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    with torch.backends.mkldnn.flags(enabled=False):
        ours = rf.resnet18(p, x)
        port = resnet18_forward(p, bn, x, train=True)[0]
    assert torch.allclose(ours, port, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("phi", [0.9, 0.99])
def test_selections_match_the_ports(phi):
    from repro_torch.core import sparsify as sp

    g = torch.Generator().manual_seed(int(phi * 100))
    x = torch.randn(300_000, generator=g) * torch.rand(300_000, generator=g)
    x[:1000] = 0.5  # ties at one magnitude
    vals, idx = sp.pack_phi(x, phi, impl="hist")
    assert torch.equal(torch.sort(idx.long()).values, omega.select_hist(x, phi))
    _, idx = sp.pack_phi(x, phi, impl="topk")
    assert torch.equal(torch.sort(idx.long()).values, torch.sort(omega.select_topk(x, phi)).values)
    _, mask = sp.omega(x, phi, impl="hist")
    assert torch.equal(mask, omega.omega_keep(x, phi))


def test_selections_of_an_all_zero_vector():
    z = torch.zeros(1000)
    assert float(omega.hist_threshold(z, 10)) == 0.0
    assert omega.omega_keep(z, 0.9).all()
    assert omega.select_hist(z, 0.9).tolist() == list(range(100))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_float8_control_fails_the_lm_limits(seed):
    """The control at the tests' size: the reference computed with float8
    products reads past at least one of every LM cell's limits, against the
    float32 reference."""
    from hflbench import check

    m = dict(TINY_LM)
    hfl = {"clusters": 2, "period": 2, "phi": [0.99, 0.9, 0.9, 0.9], "beta_s": 0.5,
           "beta_m": 0.2, "momentum": 0.9, "lr": 0.1}
    w = gen.lm_weights(m, seed, "cpu")
    b = [torch.randint(0, m["vocab_size"], (2, 4, 16),
                       generator=torch.Generator().manual_seed(seed * 10 + s)) for s in range(3)]
    numbers = check.gaps(rl.hfl_readings(w, b, m, hfl, 3, precision="fp8"),
                         rl.hfl_readings(w, b, m, hfl, 3))
    for cell in ("olmo1b-sync-h2", "olmo1b-train4k-h4", "olmo1b-sync-h2-fused"):
        limits = json.loads((ROOT / f"hflbench/workloads/{cell}.json").read_text())["limits"]
        assert check.judge(numbers, limits)[0] is False


def test_fp8_rounding_keeps_three_mantissa_bits():
    x = torch.tensor([1.0, 1.0625, 1.125, 448.0, -3.3])
    q = rl.fp8_round(x)
    assert q[0] == 1.0 and q[2] == 1.125 and abs(float(q[4]) + 3.25) < 1e-6
    assert np.isclose(float(q[3]), 448.0)


@pytest.mark.chip
def test_tf32_control_fails_the_faithful_limits():
    """The faithful cell's control (its reference with TF32 products) against
    the float32 reference at a reduced width on the card, three seeds: it
    reads past at least one limit.  TF32 exists only on the card."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 needs a CUDA device")
    from hflbench import check

    cfg = json.loads((ROOT / "hflbench/configs/resnet18-cifar-paper.json").read_text())
    m = {**cfg["model"], "width": 0.25}
    hfl = {**cfg["hfl"], "clusters": 2, "mus": 2, "period": 2}
    t = {"pool": 2, "batch_per_mu": 32, "noise": 0.6}
    limits = json.loads((ROOT / "hflbench/workloads/resnet18-paper.json").read_text())["limits"]
    for seed in (1, 2, 3):
        w = gen.resnet_weights(m, seed, "cuda")
        x, y = gen.image_pool(m, t, 4, seed, "cuda")
        b = [(x[i], y[i]) for i in range(2)]
        numbers = check.gaps(rf.faithful_readings(w, b, hfl, 2, tf32=True),
                             rf.faithful_readings(w, b, hfl, 2))
        assert check.judge(numbers, limits)[0] is False
