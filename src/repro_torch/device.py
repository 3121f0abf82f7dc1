"""Explicit device resolution: the port runs on the card unless asked not to.

``resolve()`` returns ``cuda`` by default and raises when CUDA is missing;
the CPU is used only when the caller names it (the tests pass
``device="cpu"``, the CLI ``--device cpu``). Nothing falls back silently.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):  # meta: shapes only
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
