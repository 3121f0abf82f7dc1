"""H-period orchestration (Alg. 5): the lockstep loop of ``repro.core.
schedule.run_hfl`` without the simulator, with the reference engine's call
order: train, then sync at period boundaries, then ``on_step``. The
simulator and its scenarios wait for ROADMAP Queue 1 item 12."""
from __future__ import annotations

from typing import Callable, Iterable, Optional


def run_hfl(state, train_step: Callable, sync_step: Callable,
            batches: Iterable, period: int, num_steps: int,
            on_step: Optional[Callable] = None):
    """Drive ``num_steps`` iterations, syncing when ``(step + 1) % period
    == 0``; ``on_step(step, state, losses)`` after each."""
    it = iter(batches)
    for step in range(num_steps):
        state, loss = train_step(state, next(it))
        if (step + 1) % period == 0:
            state = sync_step(state)
        if on_step is not None:
            on_step(step, state, loss)
    return state
