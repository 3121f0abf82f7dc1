"""Flops, bytes and launches of one step call: the counterpart of
``repro.launch.hlo_cost`` (an HLO text parser) behind ``obs.program_costs``.

The reference lowers and compiles a jitted step without running it and
walks the HLO. The port has no HLO and its steps update their state in
place, so it counts a call while it RUNS (``op_costs``), with what each
count means kept as close to ``hlo_cost``'s as eager PyTorch allows:

  * ``flops``: the formulas of ``torch.utils.flop_counter``
    (``FlopCounterMode``'s) on every dispatched op that has one — 2·M·N·K
    per matrix product (forward and backward), as ``hlo_cost`` counts 2 ·
    numel(result) · contracted size per ``dot``; elementwise work is not
    counted by either. ``FlopCounterMode`` itself is not used: it
    decomposes the ops it has no formula for (``silu_backward``), which
    changes their rounding and so the run. A hand-written kernel
    dispatches no op: it reports its own dot flops
    (``kernels._build.report_cost``), on the card and on ``meta``.
  * ``hbm_bytes``: the operand and result bytes of every dispatched aten
    op that does work (views and allocations move nothing), plus each
    hand-written kernel launch's operands and results
    (``kernels._build.count_launch``). These are unfused bytes, as
    ``hlo_cost`` sums the top-level instructions' operands and results.
  * ``launches``: on the card, the kernels ``torch.profiler`` sees run on
    the device (copies and fills excluded); on the CPU, the dispatched
    ops that do work.
  * ``collective_bytes``: the result bytes of every ``launch.mesh.
    all_gather`` the call makes, as ``hlo_cost`` sums the result bytes of
    each collective: on the pod paths each rank's 2·C·k payload entries
    times the pods, on the sharded path the compacted ``cap_s``
    candidates of every shard; 0.0 for the train CLI's single-process
    steps. ``collectives`` gives them per op on ``meta`` tensors, where
    nothing is allocated or sent (the dry-run's ``sync_step`` record).

Wrapping a call in these observers changes nothing it computes, so the
train CLI (``--obs-hlo-cost``) counts the first real ``train_step`` and
``sync_step`` of a run instead of an extra call that would perturb the
state.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _build
from repro_torch.launch import mesh as _mesh
from repro_torch.utils.tree import jax_leaves

# ops that allocate or only re-label memory: no bytes, no launch
_NO_WORK = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                      "new_empty_strided", "detach", "lift_fresh",
                      "_to_copy_meta"))


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _pytree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _OpCounter(TorchDispatchMode):
    """Per aten op that does work: its flops (where ``flop_registry`` has a
    formula), its operand and result bytes, one op. Each op runs as it
    would without the counter."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.nbytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not (func.is_view or func.overloadpacket.__name__ in _NO_WORK):
            self.nbytes += _nbytes((args, kwargs)) + _nbytes(out)
            self.ops += 1
        return out


def _device_kernels(prof) -> int:
    from torch.autograd import DeviceType

    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset")))


@contextlib.contextmanager
def _observed():
    """While the block runs, sum what the hand-written kernels report
    (``kernels._build.report_cost``) and keep the bytes of each
    ``launch.mesh.all_gather`` -> a dict of ``nbytes``, ``flops`` and the
    list ``gathers``."""
    seen = {"nbytes": 0, "flops": 0.0, "gathers": []}

    def observe(name, nbytes, flops):
        seen["nbytes"] += nbytes
        seen["flops"] += flops

    observe_gather = lambda axis, nbytes: seen["gathers"].append(nbytes)
    _build.launch_observers.append(observe)
    _mesh.gather_observers.append(observe_gather)
    try:
        yield seen
    finally:
        _build.launch_observers.remove(observe)
        _mesh.gather_observers.remove(observe_gather)


def op_costs(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under the counters -> ``(result,
    {"flops", "hbm_bytes", "collective_bytes", "launches"})``; on the
    card the device is waited on before and after the call."""
    on_card = any(isinstance(t, torch.Tensor) and t.is_cuda
                  for t in _pytree_leaves((args, kwargs)))
    counter = _OpCounter()
    with _observed() as seen:
        if on_card:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                with counter:
                    out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            launches = _device_kernels(prof)
        else:
            with counter:
                out = fn(*args, **kwargs)
            launches = counter.ops
    return out, {"flops": float(counter.flops + seen["flops"]),
                 "hbm_bytes": float(counter.nbytes + seen["nbytes"]),
                 "collective_bytes": float(sum(seen["gathers"])),
                 "launches": int(launches)}


def collectives(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` (on meta tensors: nothing allocated or
    sent) and count its collectives -> ``{"all-gather": {"bytes": result
    bytes}}``, ``{}`` when it makes none (the reference's ``collectives``
    record)."""
    with _observed() as seen:
        fn(*args, **kwargs)
    gathered = seen["gathers"]
    return {"all-gather": {"bytes": int(sum(gathered))}} if gathered else {}


class _Reads(TorchDispatchMode):
    """Which of ``tensors`` the dispatched ops read: a view of one (or of
    the buffer it views, as a flat-backed tree's leaves view one flat
    buffer) is followed to it, and any other op taking it reads it."""

    def __init__(self, tensors):
        super().__init__()
        self.roots = {}
        self.alive = []  # ids stay unique while tracked
        for i, t in enumerate(tensors):
            for x in (t, t._base):
                if x is not None:
                    self.roots.setdefault(id(x), set()).add(i)
                    self.alive.append(x)
        self.read = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        roots = set().union(*(self.roots[id(t)] for t in _pytree_leaves((args, kwargs))
                              if isinstance(t, torch.Tensor) and id(t) in self.roots))
        if func.is_view:
            for o in _pytree_leaves(out):
                if isinstance(o, torch.Tensor) and roots:
                    self.roots[id(o)] = roots
                    self.alive.append(o)
        else:
            self.read |= roots
        return out


def step_costs(fn, *args):
    """Run ``fn(*args)`` once under the flop counter (on meta tensors it
    runs at any size without allocating) -> (the flops ``op_costs``
    counts, per leaf of ``args`` whether the call reads or returns it).
    jax prunes a jitted step's unused arguments, so the dry-run counts
    only those leaves as the step's arguments (the reference's
    ``argument_size_in_bytes``); a leaf that is not a tensor counts."""
    leaves = [l for a in args for l in jax_leaves(a)]
    tensors = [l for l in leaves if isinstance(l, torch.Tensor)]
    counter, reads = _OpCounter(), _Reads(tensors)
    with _observed() as seen, counter, reads:
        out = fn(*args)
    returned = {id(t) for t in _pytree_leaves(out) if isinstance(t, torch.Tensor)}
    used, i = [], 0
    for l in leaves:
        if isinstance(l, torch.Tensor):
            used.append(i in reads.read or id(l) in returned)
            i += 1
        else:
            used.append(True)
    return float(counter.flops + seen["flops"]), used


class FirstCallCosts:
    """Wraps a step: its FIRST call runs under ``op_costs`` and hands the
    costs to ``report(costs)``; every call returns what the step returns.
    Attributes of the step (``collect_stats``, ``hier``, ...) are read
    through, so the engine treats the wrapper as the step itself."""

    def __init__(self, fn, report):
        self._fn, self._report, self._done = fn, report, False

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __call__(self, *args, **kwargs):
        if self._done:
            return self._fn(*args, **kwargs)
        self._done = True
        out, costs = op_costs(self._fn, *args, **kwargs)
        self._report(costs)
        return out
