"""The benchmark's generator: weights and traffic pools from ``--seed``.

Everything is drawn on the run's device by one ``torch.Generator`` seeded
with the run's seed, in a few large calls, in the dtype it is trained in;
the same seed gives the same tensors.  Both the program and the reference
are handed what this module makes.  A traffic mix is a data file of
parameters (``traffic/<name>.json``); this module is the one generator
that reads them.
"""
from __future__ import annotations

import math

import torch

from hflbench.metrics._yardstick import padded_vocab

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator for one stream of the run (0: weights, 1: traffic)."""
    return torch.Generator(device=device).manual_seed((int(seed) * 4 + stream) % (1 << 63))


def _normal(gen, shape, scale, dtype, device):
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def lm_weights(m: dict, seed: int, device):
    """olmo-style weights in the port's tree layout: leaves stacked over the
    layers, the non-parametric norms' placeholders (zeros, f32, part of the
    flat vector), the embedding padded to ``padded_vocab`` rows and tied to
    the head.  Scales 0.02 (embedding), 1/√fan_in (projections)."""
    gen = generator(seed, device, 0)
    dt = DTYPES[m["dtype"]]
    L, d, f = m["num_layers"], m["d_model"], m["d_ff"]
    H, Hkv, D = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    nrm = lambda *lead: {"_np": torch.zeros(lead + (1,), device=device)}
    g = lambda shape, scale: _normal(gen, shape, scale, dt, device)
    return {
        "embed": g((padded_vocab(m["vocab_size"]), d), 0.02),
        "blocks": {
            "attn": {"wq": g((L, d, H * D), d ** -0.5), "wk": g((L, d, Hkv * D), d ** -0.5),
                     "wv": g((L, d, Hkv * D), d ** -0.5),
                     "wo": g((L, H * D, d), (H * D) ** -0.5)},
            "ffn": {"w_gate": g((L, d, f), d ** -0.5), "w_up": g((L, d, f), d ** -0.5),
                    "w_down": g((L, f, d), f ** -0.5)},
            "norm1": nrm(L), "norm2": nrm(L),
        },
        "final_norm": nrm(),
    }


def lm_pool(m: dict, t: dict, clusters: int, seed: int, device):
    """Token rows [pool, N, M·B, T], uniform over the vocabulary: every row
    of every batch its own draw."""
    gen = generator(seed, device, 1)
    shape = (t["pool"], clusters, t["mus"] * t["batch_per_mu"], t["seq"])
    return torch.randint(0, m["vocab_size"], shape, generator=gen, device=device)


def resnet_channels(m: dict):
    return [max(8, int(c * m["width"])) for c in (64, 128, 256, 512)]


def resnet_weights(m: dict, seed: int, device):
    """ResNet-18 in the port's layout (HWIO kernels, He-normal; BatchNorm
    scale 1 and bias 0; the classifier N(0, 0.01²))."""
    gen = generator(seed, device, 0)
    ch = resnet_channels(m)
    conv = lambda kh, cin, cout: _normal(gen, (kh, kh, cin, cout), math.sqrt(2.0 / (kh * kh * cin)),
                                         torch.float32, device)
    bn = lambda c: {"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device)}
    p = {"conv0": conv(3, 3, ch[0]), "bn0": bn(ch[0])}
    cin = ch[0]
    for si, (c, stride) in enumerate(zip(ch, (1, 2, 2, 2))):
        for bi in range(2):
            pre, st = f"s{si}b{bi}", (stride if bi == 0 else 1)
            p[pre + "c1"], p[pre + "bn1"] = conv(3, cin, c), bn(c)
            p[pre + "c2"], p[pre + "bn2"] = conv(3, c, c), bn(c)
            if st != 1 or cin != c:
                p[pre + "proj"], p[pre + "bnp"] = conv(1, cin, c), bn(c)
            cin = c
    p["fc_w"] = _normal(gen, (cin, m["num_classes"]), 0.01, torch.float32, device)
    p["fc_b"] = torch.zeros(m["num_classes"], device=device)
    return p


def image_pool(m: dict, t: dict, mus: int, seed: int, device):
    """CIFAR-shaped images [pool, K, B, 32, 32, 3] and labels [pool, K, B]:
    one N(0, 1) template a class plus N(0, noise²) noise an image, the
    labels uniform over the classes."""
    gen = generator(seed, device, 1)
    C, (h, w, c) = m["num_classes"], m["image"]
    templates = torch.randn((C, h, w, c), generator=gen, device=device)
    lead = (t["pool"], mus, t["batch_per_mu"])
    y = torch.randint(0, C, lead, generator=gen, device=device)
    x = torch.randn(lead + (h, w, c), generator=gen, device=device).mul_(t["noise"])
    return x.add_(templates[y]), y
