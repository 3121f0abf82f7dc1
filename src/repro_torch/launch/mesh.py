"""Meshes over ``torch.distributed`` (the port of ``repro.launch.mesh``),
the collectives the mesh syncs need, and a launcher for rank processes.

Single pod: 16 x 16 = 256 ranks, axes ("data", "model"). Multi-pod:
2 x 16 x 16 = 512 ranks, axes ("pod", "data", "model"): the "pod" axis
carries the paper's clusters, and cross-pod traffic happens only in the
every-H sparse sync. A mesh is a ``DeviceMesh`` whose dims carry those
names; rank r sits at the row-major coordinate of r in the mesh shape.

The process group is initialized explicitly (``init_process_group``): its
address, world size and rank come from the caller. The backend is NCCL
when the ranks run on cards, gloo when the caller names the CPU, or names
gloo itself (several ranks sharing one card, which NCCL refuses).

Run ``python -m repro_torch.launch.mesh --target FILE_OR_MODULE:FUNCTION
--world W --out DIR`` (or ``run_ranks``) to start W rank processes, each
calling ``FUNCTION(rank=r, world=W, **kwargs)`` after joining the group.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import socket
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist


def init_process_group(rank: int, world_size: int, port: int, *,
                       device: str = "cuda", backend: Optional[str] = None,
                       host: str = "localhost", timeout_s: float = 300.0) -> str:
    """Join the default process group at ``tcp://host:port``; -> the
    backend. ``backend`` defaults to NCCL on ``cuda`` and gloo on ``cpu``;
    on ``cuda`` the rank's card is ``rank % device_count``."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_process_group: device 'cuda' asked, but "
                               "CUDA is not available (pass device='cpu')")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    elif device != "cpu":
        raise ValueError(device)
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{host}:{port}",
                            rank=rank, world_size=world_size,
                            timeout=timedelta(seconds=timeout_s))
    return backend


def _mesh(device_type: Optional[str], shape, axes):
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:  # the mesh's device type is the group's
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def make_host_mesh(*, pods: int = 1, data: int = 1, model: int = 1,
                   device_type: Optional[str] = None):
    """Small mesh over the group's ranks (tests, one card): "pod" only when
    ``pods > 1``, then "data" and "model"."""
    axes, shape = [], []
    if pods > 1:
        axes.append("pod")
        shape.append(pods)
    axes += ["data", "model"]
    shape += [data, model]
    return _mesh(device_type, shape, axes)


def axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def axis_size(mesh, name: str) -> int:
    return mesh.size(axis_names(mesh).index(name)) if name in axis_names(mesh) else 1


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size}."""
    return {a: axis_size(mesh, a) for a in axis_names(mesh)}


def mesh_coord(mesh) -> Dict[str, int]:
    """{axis name: this rank's index along it}."""
    return {a: mesh.get_local_rank(a) for a in axis_names(mesh)}


# callables ``observe(axis, nbytes)``, told of every all-gather's result
# bytes (``launch.op_cost`` counts the collectives of a call with these)
gather_observers: list = []


def all_gather(t, mesh, axis: str):
    """Every rank's ``t`` along ``axis``, stacked in axis order: [size,
    *t.shape] on t's device.

    NCCL gathers device tensors on the device. Gloo takes host tensors
    only, so under a gloo group the payload is copied to host memory and
    the result back to t's device: this is transport, the compute stays
    on the rank's device. bf16 travels as its bytes (gloo has no 16-bit
    types). A ``meta`` tensor has no data to send: the result has the
    gathered shape and nothing moves (the dry-run evaluates a mesh sync
    so, over a fake process group)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t[None]
    for observe in gather_observers:
        observe(axis, n * t.numel() * t.element_size())
    if t.device.type == "meta":
        return t[None].expand((n,) + tuple(t.shape)).contiguous()
    group = mesh.get_group(axis)
    x = t.contiguous()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.uint8)
    host = dist.get_backend(group) == "gloo" and x.device.type != "cpu"
    if host:
        x = x.cpu()
    out = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(out, x, group=group)
    y = torch.stack(out)
    if host:
        y = y.to(t.device)
    return y.view(t.dtype) if t.dtype == torch.bfloat16 else y


def gather_shard_major(t, mesh, axes: Sequence[str]):
    """``t`` of every rank over ``axes``, stacked shard-major [S, *t.shape]:
    the innermost axis is gathered first, so the first axis varies
    slowest, the order of the pieces of the sharded flat vector."""
    for a in reversed(axes):
        t = all_gather(t, mesh, a)
    return t.reshape((-1,) + t.shape[len(axes):])


def shard_index(mesh, axes: Sequence[str]) -> int:
    """This rank's linear index over ``axes``, the first axis slowest."""
    lin = 0
    for a in axes:
        lin = lin * axis_size(mesh, a) + mesh.get_local_rank(a)
    return lin


# ---------------------------------------------------------------------------
# Rank processes
# ---------------------------------------------------------------------------


def free_port() -> int:
    """A TCP port on localhost nobody listens on right now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _load(target: str):
    where, fn = target.rsplit(":", 1)
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(Path(where).stem, where)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(where)
    return getattr(mod, fn)


def run_ranks(target: str, world: int, kwargs: dict, out_dir, *,
              device: str = "cuda", backend: Optional[str] = None,
              timeout_s: float = 120.0, env: Optional[dict] = None) -> list:
    """Start ``world`` rank processes of ``target`` (``path.py:function``
    or ``module:function``), each calling ``function(rank=r, world=world,
    **kwargs)`` in a group on a fresh localhost port; -> each rank's
    return value (JSON), in rank order. When a rank fails, or the run
    passes ``timeout_s``, every rank still running is killed and the error
    names each rank that did not finish cleanly, with its output."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    port = free_port()
    cmd = [sys.executable, "-m", "repro_torch.launch.mesh", "--target", target,
           "--world", str(world), "--port", str(port), "--out", str(out_dir),
           "--device", device, "--kwargs", json.dumps(kwargs)]
    if backend:
        cmd += ["--backend", backend]
    procs = []
    for r in range(world):
        log = open(out_dir / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(cmd + ["--rank", str(r)], stdout=log,
                                       stderr=subprocess.STDOUT, env=env), log))
    deadline = time.monotonic() + timeout_s
    try:
        while (any(p.poll() is None for p, _ in procs)
               and not any(p.poll() for p, _ in procs)
               and time.monotonic() < deadline):
            time.sleep(0.05)
        grace = time.monotonic() + 5.0  # ranks already on their way out
        while (any(p.poll() is None for p, _ in procs) and time.monotonic() < grace
               and time.monotonic() < deadline):
            time.sleep(0.05)
        codes = [p.poll() for p, _ in procs]
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    bad = [r for r, c in enumerate(codes) if c != 0]
    if bad:
        msg = [f"run_ranks({target}):"]
        for r in bad:
            why = (f"timed out after {timeout_s} s" if codes[r] is None
                   else f"failed (exit {codes[r]})")
            tail = (out_dir / f"rank{r}.log").read_text()[-3000:]
            msg.append(f"rank {r} {why}:\n{tail}")
        raise RuntimeError("\n".join(msg))
    return [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(world)]


def _rank_main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.mesh")
    ap.add_argument("--target", required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None)
    ap.add_argument("--kwargs", default="{}")
    a = ap.parse_args(argv)
    fn = _load(a.target)
    init_process_group(a.rank, a.world, a.port, device=a.device, backend=a.backend)
    try:
        result = fn(rank=a.rank, world=a.world, **json.loads(a.kwargs))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    tmp = Path(a.out) / f"rank{a.rank}.json.tmp"
    tmp.write_text(json.dumps(result))
    os.replace(tmp, Path(a.out) / f"rank{a.rank}.json")
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main())
