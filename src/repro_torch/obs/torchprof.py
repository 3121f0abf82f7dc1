"""Profiling hooks: first-step vs steady timing, live memory, op costs (the
port of ``repro.obs.jaxprof``).

  * ``StepClock`` — splits wall time into the first step (on the card:
    the kernels' first launch, allocator growth, cuBLAS heuristics; there
    is no trace + compile as under jit) and the steady state:
    ``compile_s`` keeps the reference's name for the first step's time,
    ``steady_s_per_step`` averages the steps after it.
  * ``program_costs`` — the flops, bytes and launches of one call
    (``launch/op_cost``).
  * ``live_bytes`` / ``device_memory_stats`` — the card's allocator (the
    heartbeat's live-memory probe).
"""
from __future__ import annotations

import time

import torch


class StepClock:
    """Wall-clock accountant for a step loop.

    Call ``step()`` after each completed step; the first completion marks
    the end of the warm-up step. ``steady_s_per_step`` averages strictly
    post-warm-up steps (None until a second step lands).
    """

    def __init__(self):
        self.t0 = time.perf_counter()
        self._t_first = None
        self._steps = 0

    def step(self) -> None:
        self._steps += 1
        if self._t_first is None:
            self._t_first = time.perf_counter()

    @property
    def steps(self) -> int:
        return self._steps

    @property
    def compile_s(self):
        """First-step wall time (warm-up + one execution)."""
        return (None if self._t_first is None
                else self._t_first - self.t0)

    @property
    def steady_s_per_step(self):
        if self._t_first is None or self._steps < 2:
            return None
        return (time.perf_counter() - self._t_first) / (self._steps - 1)

    def summary(self) -> dict:
        return {"steps": self._steps, "compile_s": self.compile_s,
                "steady_s_per_step": self.steady_s_per_step}


def program_costs(fn, *args, **kwargs) -> dict:
    """Flops, bytes and launches of ONE call ``fn(*args, **kwargs)``, which
    this RUNS (the port's steps update their state in place, so nothing
    can be costed without running it): see ``launch.op_cost.op_costs``.
    The call's own result is discarded (use ``op_costs`` to keep it)."""
    from repro_torch.launch.op_cost import op_costs

    return op_costs(fn, *args, **kwargs)[1]


def live_bytes() -> float:
    """Bytes the card's caching allocator holds in live tensors
    (``torch.cuda.memory_allocated``). On the CPU it is 0.0: PyTorch keeps
    no count of the host tensors alive (the reference sums
    ``jax.live_arrays()``, which has no torch counterpart)."""
    if not torch.cuda.is_available():
        return 0.0
    return float(torch.cuda.memory_allocated())


def device_memory_stats() -> dict:
    """``torch.cuda.memory_stats()`` of the current card (empty on the
    CPU)."""
    if not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats())
