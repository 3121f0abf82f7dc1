"""Dense FFN: SwiGLU (gated, 3 matrices) or classic act-MLP (2 matrices)."""
from __future__ import annotations

import math

from repro_torch.device import resolve
from repro_torch.models.common import act_fn, default_scale, dense_init, torch_dtype


def init_mlp(gen, cfg, lead=(), device=None, d_ff=None):
    device = resolve(device)
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    dt = torch_dtype(cfg.dtype)
    lead = tuple(lead)
    p = {
        "w_gate": dense_init(gen, lead + (d, f), dt, default_scale(d), device),
        "w_down": dense_init(gen, lead + (f, d), dt, 1.0 / math.sqrt(f), device),
    }
    if cfg.gated_mlp:
        p["w_up"] = dense_init(gen, lead + (d, f), dt, default_scale(d), device)
    return p


def mlp_forward(p, x, cfg):
    a = act_fn(cfg.act)(x @ p["w_gate"])
    if cfg.gated_mlp:
        a = a * (x @ p["w_up"])
    return a @ p["w_down"]
