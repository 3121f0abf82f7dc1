"""Multi-pod dry-run: the port of ``repro.launch.dryrun``.

Evaluates every (architecture x input shape) pair on the production
meshes (single pod 16 x 16 = 256 ranks, multi-pod 2 x 16 x 16 = 512) with
nothing allocated, and prints and records each program's per-rank
memory, flops and collectives.

The reference lowers and compiles each step with XLA and reads the
compiled program. PyTorch has no ahead-of-time compile of a whole step,
and the port has no partitioner, so each number comes from what the port
can evaluate without a card or a payload:
  * ``memory.argument_bytes``: the bytes of one rank's blocks of every
    input the step reads or returns (``launch.sharding.shaped``, the
    reference's specs and dtypes). XLA's ``memory_analysis().
    argument_size_in_bytes`` counts exactly these: jax prunes a jitted
    step's unused arguments (olmo's norm placeholders in a serve step),
    and the specs shard only axes that divide evenly, so every rank's
    blocks have one size.
  * ``collectives``: for ``sync_step``, the result bytes of the mesh
    sync's all-gathers, run on one rank's ``meta`` blocks over torch's
    fake process group. This equals the reference's trip-count-aware
    count of its compiled sync (``hlo_cost``): all-gathers of the same
    bytes, and no other collective. None for the model steps: the reference's are the
    collectives XLA's partitioner inserts, and the port has no
    partitioner.
  * ``cost.flops``: None. The reference's is XLA's per-device count of
    the partitioned program, remat recompute and the partitioner's own
    work included. ``cost.flops_global`` is ``launch.op_cost``'s counted
    flops of the unpartitioned step run on ``meta`` tensors at global
    shapes, and ``cost.flops_unpartitioned`` is that over the ranks.
  * ``memory.temp_bytes``, ``output_bytes`` and ``alias_bytes``: None.
  ``notes`` says why for each None.

The mesh is ``launch.mesh.make_production_mesh`` over torch's fake process
group (``FakeStore``): the 256 or 512 ranks are never joined.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out f.json]
"""
import argparse
import json
import sys
import time
import traceback
from contextlib import contextmanager

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config, get_shape
from repro_torch.configs.base import HFLConfig
from repro_torch.core.hfl import SyncPlan, hfl_init, make_sync, rank_state
from repro_torch.launch import steps as st
from repro_torch.launch import mesh as M
from repro_torch.launch.op_cost import collectives, step_costs
from repro_torch.utils.tree import jax_leaves
from repro_torch.models.transformer import frontend_dim, init_cache

NOTES = ["temp_bytes, output_bytes and alias_bytes are None: the port has no "
         "partitioner, so there is no per-rank compiled program to measure",
         "cost.flops is None: the reference's is the partitioned program's per-device "
         "count; flops_unpartitioned is the unpartitioned step's counted flops "
         "(flops_global) over the ranks, not the reference's number"]
MODEL_COLLECTIVES_NOTE = ("collectives is None: the reference's are those its "
                          "partitioner inserts into the model step; the port has no "
                          "partitioner")


@contextmanager
def fake_world(world: int):
    """torch's fake process group of ``world`` ranks: meshes of that size
    can be built, and no rank is joined and nothing is sent."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry-run makes its own fake process group; "
                           "a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def argument_bytes(inputs, used=None) -> int:
    """One rank's bytes of the blocks of the ``inputs`` (a sequence of trees
    of ``launch.sharding.ShapeDtypeStruct``), of the leaves ``used`` flags
    (all by default)."""
    leaves = [l for x in inputs for l in jax_leaves(x)]
    used = used or [True] * len(leaves)
    return sum(l.block_nbytes for l, u in zip(leaves, used, strict=True) if u)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _record(args_bytes, flops_global, n, colls=None):
    """A program's record; ``colls`` None for a model step."""
    return {
        "memory": {"argument_bytes": int(args_bytes), "output_bytes": None,
                   "temp_bytes": None, "alias_bytes": None},
        "cost": {"flops": None, "flops_unpartitioned": flops_global / n,
                 "flops_global": flops_global},
        "collectives": colls,
        "n_devices": n,
        "notes": NOTES + ([MODEL_COLLECTIVES_NOTE] if colls is None else []),
    }


def _train_programs(cfg, shape, mesh, hfl, n, records):
    """``train_step``'s record, and ``sync_step``'s on a mesh with pods."""
    data = M.axis_size(mesh, "data")
    state_sds, batch_sds, pspecs = st.train_input_specs(cfg, shape, mesh, hfl)
    bax = ("data",) if (shape.global_batch // hfl.num_clusters) % data == 0 else None
    step = st.build_train_step(cfg, groups=data, batch_axes=bax)
    state = hfl_init(st.model_shapes(cfg), st.default_optimizer(), hfl)  # meta
    batch = {k: _meta(v.shape, torch.int64 if k == "tokens" else v.dtype)
             for k, v in batch_sds.items()}
    flops, used = step_costs(step, state, batch)
    records["train_step"] = _record(argument_bytes((state_sds, batch_sds), used),
                                    flops, n)
    if M.axis_size(mesh, "pod") > 1:
        sync = st.build_sync_step(hfl, mesh, pspecs)
        plan = SyncPlan(hfl, mesh=mesh, param_specs=pspecs)
        dims = M.mesh_shape(mesh)
        local = rank_state(state, plan, dims, {a: 0 for a in dims})
        colls = collectives(sync, local)
        flops, used = step_costs(make_sync(SyncPlan(hfl)), state)
        records["sync_step"] = _record(argument_bytes((state_sds,), used), flops, n,
                                       colls)


def dryrun_pair(arch: str, shape_name: str, *, multi_pod: bool, verbose=True,
                cfg=None, mesh_shape=None):
    """One (arch x shape) pair on the production mesh (``multi_pod``), or
    on a (data, model) / (pod, data, model) mesh of ``mesh_shape``; ``cfg``
    replaces ``get_config(arch)`` (a reduced configuration)."""
    cfg = cfg or get_config(arch)
    shape = get_shape(shape_name)

    if shape.kind == "decode" and shape_name == "long_500k" and not cfg.subquadratic:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": "full-attention arch; see DESIGN.md §4"}

    if mesh_shape is None:
        world = 512 if multi_pod else 256
    else:
        world = int(np.prod(mesh_shape))
    t0 = time.time()
    records = {}
    with fake_world(world):
        if mesh_shape is None:
            mesh = M.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        else:
            pods = mesh_shape[0] if len(mesh_shape) == 3 else 1
            mesh = M.make_host_mesh(pods=pods, data=mesh_shape[-2],
                                    model=mesh_shape[-1], device_type="cpu")
        data = M.axis_size(mesh, "data")
        n_pods = M.axis_size(mesh, "pod")
        n = world
        hfl = HFLConfig(num_clusters=n_pods, mus_per_cluster=data, period=4,
                        sync_mode="sparse")
        B, S = shape.global_batch, shape.seq_len
        params = st.model_shapes(cfg)  # meta
        if shape.kind == "train":
            _train_programs(cfg, shape, mesh, hfl, n, records)
        elif shape.kind == "prefill":
            groups = data if B % data == 0 else 1
            sds = st.serve_input_specs(cfg, shape, mesh, mode="prefill")
            bax = ("data",) if B % data == 0 else None
            step = st.build_prefill_step(cfg, groups=groups, batch_axes=bax)
            F = cfg.frontend_tokens if cfg.frontend != "none" else 0
            args = [params, _meta((B, S - F), torch.int64)]
            if F:
                args.append(_meta((B, F, frontend_dim(cfg)), torch.float32))
            flops, used = step_costs(step, *args)
            records["prefill_step"] = _record(argument_bytes(sds, used), flops, n)
        else:  # decode
            sds = st.serve_input_specs(cfg, shape, mesh, mode="decode")
            bax = ("data",) if B % data == 0 else None
            step = st.build_decode_step(cfg, groups=1, batch_axes=bax)
            flops, used = step_costs(step, params, init_cache(cfg, B, S, device="meta"),
                                     _meta((B, 1), torch.int64))
            records["serve_step"] = _record(argument_bytes(sds, used), flops, n)

    rec = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "status": "ok", "compile_s": round(time.time() - t0, 1),
        "programs": records,
    }
    if verbose:
        for name, r in records.items():
            colls = r["collectives"]
            print(f"  {name}: flops/dev=n/a "
                  f"(unpartitioned {r['cost']['flops_unpartitioned']:.3e}) "
                  f"mem: args={r['memory']['argument_bytes']/2**30:.2f}GiB "
                  f"temp=n/a "
                  f"colls={ {k: v['bytes'] for k, v in colls.items()} if colls is not None else 'n/a'}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    pairs = []
    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = sorted(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for a in archs:
        for s in shapes:
            for mp in meshes:
                pairs.append((a, s, mp))

    results = []
    for a, s, mp in pairs:
        tag = f"{a} x {s} x {'2pod/512' if mp else '1pod/256'}"
        print(f"[dryrun] {tag}", flush=True)
        try:
            rec = dryrun_pair(a, s, multi_pod=mp)
        except Exception as e:
            traceback.print_exc()
            rec = {"arch": a, "shape": s, "multi_pod": mp,
                   "status": "error", "error": f"{type(e).__name__}: {e}"}
        print(f"[dryrun] {tag} -> {rec['status']}", flush=True)
        results.append(rec)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    bad = [r for r in results if r["status"] == "error"]
    print(f"[dryrun] done: {len(results)-len(bad)} ok, {len(bad)} errors")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
