"""H-period orchestration (Alg. 5): the lockstep loop of ``repro.core.
schedule.run_hfl`` without the simulator, with the reference engine's call
order: train, then sync at period boundaries, then ``on_step``. A tree
with an async top tier runs the simulator's unit scheduler in its
null-wireless mode, as the reference's adapter does. The simulator's
scenarios run through ``repro_torch.sim`` instead."""
from __future__ import annotations

from typing import Callable, Iterable, Optional


def run_hfl(state, train_step: Callable, sync_step: Callable,
            batches: Iterable, period: int, num_steps: int,
            on_step: Optional[Callable] = None,
            on_async_sync: Optional[Callable] = None):
    """Drive ``num_steps`` iterations, syncing when ``(step + 1) % period
    == 0``; ``on_step(step, state, losses)`` after each.

    ``period`` is the TIER-1 period. A depth > 2 ``sync_step``
    (``core.hfl.HierSyncStep``, its ``hier`` attribute set) is called
    ``sync_step(state, bufs, top)`` on its own buffers, ``top`` the highest
    boundary due (``fire_top``). If a tier of it is not lockstep, the
    simulator runs it without a radio (``SimEngine(period=...,
    record=False)``, which resolves and checks the tiers' disciplines): an
    async top suffix is its unit scheduler, which reports each unit sync
    and push to ``on_async_sync(event, state)``."""
    if getattr(sync_step, "hier", False):
        if any(tc.discipline != "lockstep" for tc in sync_step.cfg.tiers[1:]):
            from repro_torch.sim.engine import SimEngine

            engine = SimEngine(period=period, record=False)
            state, _trace = engine.run(state, train_step, sync_step, batches,
                                       num_steps, on_step=on_step,
                                       on_async_sync=on_async_sync)
            return state
        bufs = sync_step.init_bufs(state)
    it = iter(batches)
    for step in range(num_steps):
        state, loss = train_step(state, next(it))
        if (step + 1) % period == 0:
            if getattr(sync_step, "hier", False):
                top = sync_step.fire_top((step + 1) // period)
                state, bufs = sync_step(state, bufs, top)
            else:
                state = sync_step(state)
        if on_step is not None:
            on_step(step, state, loss)
    return state
