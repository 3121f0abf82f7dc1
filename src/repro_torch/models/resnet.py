"""ResNet-18 (He et al., 2016), the paper's own CIFAR-10 model
(``repro.models.resnet``), as plain functions on tensors.

The parameters keep the reference's layout so flat index i names the
same entry in both packages: convolution kernels are HWIO
``[kh, kw, cin, cout]``, and the input is NHWC ``[B, 32, 32, 3]``. Each
convolution permutes its kernel to OIHW for ``F.conv2d`` and runs NCHW
inside. XLA's ``"SAME"`` padding is asymmetric at stride 2 (the extra row
and column go after), so every convolution pads explicitly
(``_same_pads``) instead of passing ``padding=1``.

BatchNorm keeps running stats in a separate ``state`` tree: training
normalizes with the batch mean and the population variance (ddof 0, as
``jnp.var``) and returns the updated running stats; eval uses the running
stats. The convolutions and the final matmul are library calls, as they
were XLA's in the reference (never Pallas).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve

_STAGES = [(64, 1), (128, 2), (256, 2), (512, 2)]  # (channels, first-stride)
_BN_EPS = 1e-5


def _same_pads(size: int, k: int, stride: int):
    """(before, after) padding of XLA's "SAME" along one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x, w, stride: int = 1):
    """x NCHW, w HWIO -> NCHW, "SAME" padding as XLA computes it."""
    kh, kw = w.shape[0], w.shape[1]
    ph = _same_pads(x.shape[2], kh, stride)
    pw = _same_pads(x.shape[3], kw, stride)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def _conv_init(gen, kh, kw, cin, cout, device):
    fan_in = kh * kw * cin
    return (torch.randn((kh, kw, cin, cout), generator=gen, device=device)
            * (2.0 / fan_in) ** 0.5)


def _bn_init(c, device):
    return ({"scale": torch.ones(c, device=device),
             "bias": torch.zeros(c, device=device)},
            {"mean": torch.zeros(c, device=device),
             "var": torch.ones(c, device=device)})


def _bn_apply(p, s, x, train: bool, momentum=0.9):
    """x NCHW; statistics over (batch, H, W) per channel."""
    if train:
        mu = x.mean(dim=(0, 2, 3))
        var = (x - mu[:, None, None]).square().mean(dim=(0, 2, 3))
        new_s = {"mean": momentum * s["mean"] + (1 - momentum) * mu.detach(),
                 "var": momentum * s["var"] + (1 - momentum) * var.detach()}
    else:
        mu, var = s["mean"], s["var"]
        new_s = s
    c = lambda t: t[:, None, None]
    y = (x - c(mu)) / torch.sqrt(c(var) + _BN_EPS) * c(p["scale"]) + c(p["bias"])
    return y, new_s


def init_resnet18(gen: torch.Generator, num_classes: int = 10,
                  width: float = 1.0, device=None):
    """(params, bn_state) in the reference's tree layout, random from
    ``gen``, on the card unless ``device`` names another."""
    device = resolve(device)
    ch = [max(8, int(c * width)) for c, _ in _STAGES]
    params, state = {}, {}
    params["conv0"] = _conv_init(gen, 3, 3, 3, ch[0], device)
    params["bn0"], state["bn0"] = _bn_init(ch[0], device)
    cin = ch[0]
    for si, (c, stride) in enumerate(zip(ch, [s for _, s in _STAGES])):
        for bi in range(2):
            pre = f"s{si}b{bi}"
            st = stride if bi == 0 else 1
            params[pre + "c1"] = _conv_init(gen, 3, 3, cin, c, device)
            params[pre + "bn1"], state[pre + "bn1"] = _bn_init(c, device)
            params[pre + "c2"] = _conv_init(gen, 3, 3, c, c, device)
            params[pre + "bn2"], state[pre + "bn2"] = _bn_init(c, device)
            if st != 1 or cin != c:
                params[pre + "proj"] = _conv_init(gen, 1, 1, cin, c, device)
                params[pre + "bnp"], state[pre + "bnp"] = _bn_init(c, device)
            cin = c
    params["fc_w"] = torch.randn((cin, num_classes), generator=gen,
                                 device=device) * 0.01
    params["fc_b"] = torch.zeros(num_classes, device=device)
    return params, state


def resnet18_forward(params, state, x, train: bool):
    """x [B, 32, 32, 3] (NHWC) -> (logits [B, C], new_state)."""
    new_state = {}
    h = conv(x.permute(0, 3, 1, 2), params["conv0"])
    h, new_state["bn0"] = _bn_apply(params["bn0"], state["bn0"], h, train)
    h = torch.relu(h)
    for si, (_, stride) in enumerate(_STAGES):
        for bi in range(2):
            pre = f"s{si}b{bi}"
            st = stride if bi == 0 else 1
            idt = h
            y = conv(h, params[pre + "c1"], st)
            y, new_state[pre + "bn1"] = _bn_apply(
                params[pre + "bn1"], state[pre + "bn1"], y, train)
            y = torch.relu(y)
            y = conv(y, params[pre + "c2"])
            y, new_state[pre + "bn2"] = _bn_apply(
                params[pre + "bn2"], state[pre + "bn2"], y, train)
            if pre + "proj" in params:
                idt = conv(idt, params[pre + "proj"], st)
                idt, new_state[pre + "bnp"] = _bn_apply(
                    params[pre + "bnp"], state[pre + "bnp"], idt, train)
            h = torch.relu(y + idt)
    h = h.mean(dim=(2, 3))
    return h @ params["fc_w"] + params["fc_b"], new_state
