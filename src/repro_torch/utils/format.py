"""Tiny shared formatting helpers for CLI output (the port of
``repro.utils.format``)."""
from __future__ import annotations


def format_metrics(metrics: dict, *, skip: tuple = ()) -> str:
    """``k=v`` CSV body with 4-sig-digit floats."""
    return ",".join(
        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in metrics.items() if k not in skip
    )
