"""The comparison that decides ``correct`` for the training cells.

Both sides report readings of the same first steps of one run: ``loss``
[step][row] (each step's loss), ``grad1`` {leaf: [row]} (the norm of the
first gradient as the optimizer holds it after one step) and ``change``
{leaf: [row]} (the norm of each row's change after the steps followed).
Three numbers are compared, each against its limit from the cell's file:

* ``loss_gap``: the largest |loss - loss_ref| / |loss_ref| over the steps
  followed, or ``loss1_gap`` over the first step's alone where the driver
  says so (``loss_steps``): where a later step's loss swings with a
  selection of Ω that rounding flips, while the first one's stays steady;
* ``grad1_gap``: by the worst leaf, | |g| - |g_ref| | over the larger of
  |g_ref| and the median leaf's |g_ref|;
* ``change_gap``: the same for the change, over the leaves whose reference
  gradient is at least a thousandth of the median leaf's (the others, such
  as the norms' placeholders, move by round-off alone).

A limit of ``None`` reports the number without holding the run to it.
"""
from __future__ import annotations

import math
import statistics

NOUGHT = 1e-3


def _leaf(name: str) -> str:
    return name.split("/", 1)[1] if name.startswith("w_ref/") else name


def _worst(prog: dict, ref: dict, names) -> float:
    vals = [(p, r) for n in names for p, r in zip(prog[n], ref[n])]
    if not vals:
        return 0.0
    med = statistics.median(r for _, r in vals)
    return max(abs(p - r) / max(r, med, 1e-30) for p, r in vals)


def loss_gaps(prog: dict, ref: dict) -> list:
    """Each step's largest |loss - loss_ref| / |loss_ref| over its rows (a
    loss that is not finite reads inf)."""
    return [max(abs(p - r) / max(abs(r), 1e-30) if math.isfinite(p) else math.inf
                for p, r in zip(ps, rs))
            for ps, rs in zip(prog["loss"], ref["loss"])]


def gaps(prog: dict, ref: dict, loss_steps=None) -> dict:
    by_step = loss_gaps(prog, ref)
    loss = ({"loss_gap": max(by_step)} if loss_steps is None
            else {f"loss{loss_steps}_gap": max(by_step[:loss_steps])})
    g_ref = {n: sum(v) / len(v) for n, v in ref["grad1"].items()}
    med = statistics.median(g_ref.values())
    moved = [n for n in ref["change"] if g_ref.get(_leaf(n), 0.0) >= NOUGHT * med]
    return {**loss,
            "grad1_gap": _worst(prog["grad1"], ref["grad1"], list(ref["grad1"])),
            "change_gap": _worst(prog["change"], ref["change"], moved)}


def judge(numbers: dict, limits: dict):
    """-> (correct, {name: {"value", "limit"}}): every number finite and at
    or under its limit."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        out[name] = {"value": value, "limit": limit}
        if not math.isfinite(value) or (limit is not None and value > limit):
            ok = False
    return ok, out
