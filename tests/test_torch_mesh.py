"""The mesh syncs over ``torch.distributed``, ranks spawned on the CPU
(gloo), against the reference's mesh syncs run in a subprocess on faked
host devices (``--xla_force_host_platform_device_count=8``).

  * (data, model) = (2, 2), 4 ranks: the sharded flat sync (fused Ω). The
    merged rank states equal the port's ``flat_shards=4`` emulation and
    the reference's mesh output bit for bit (``assert_array_equal``).
  * (pod, data, model) = (2, 2, 2), 8 ranks: the pod-mesh flat layout with
    ``topk`` and ``pallas`` Ω, the leaf layout and dense averaging, against
    the reference's pod-mesh output (``tests/test_hfl.py``'s setup, with
    nonzero error buffers so δ's rounding shows), bit for bit; on the
    reference's own state (zero buffers) its three invariants: consensus,
    conservation (rtol 1e-4, atol 1e-5, the reference test's) and adoption.
  * the rank blocks: ``launch.sharding.rank_block`` equals what
    ``jax.device_put`` with a ``NamedSharding`` hands each device.

Each rank run has its own port and a timeout; the reference runs once per
module. Rank processes import this file without jax (its jax imports are
inside the test functions).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import HFLConfig
from repro_torch.core import hfl as thfl
from repro_torch.launch import mesh as M
from repro_torch.launch.sharding import P, param_specs, rank_block
from repro_torch.utils.convert import state_from_numpy
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("params", "w_ref", "eps", "e")

_REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs.base import HFLConfig, ModelConfig
    from repro.core.hfl import SyncPlan, hfl_init, make_sync
    from repro.launch.sharding import param_specs
    from repro.models.transformer import init_model
    from repro.optim import SGDM

    out = {}
    def save(prefix, state):
        for f in ("params", "w_ref", "eps", "e"):
            for path, x in jax.tree_util.tree_flatten_with_path(getattr(state, f))[0]:
                out[prefix + "|" + f + "|" + "/".join(k.key for k in path)] = np.asarray(x)
        for path, x in jax.tree_util.tree_flatten_with_path(state.opt)[0]:
            out[prefix + "|opt|" + "/".join(k.key for k in path)] = np.asarray(x)
    def tiers(h):
        return [[t.fanout, t.period, t.phi_up, t.phi_down, t.beta_up, t.beta_down]
                for t in h.tiers]
    devs = np.array(jax.devices())

    # (data, model) = (2, 2): tests/test_sharding.py's sharded flat setup
    cfg = ModelConfig(name="t", arch_type="dense", num_layers=2, d_model=32,
                      num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=61,
                      dtype="float32", remat=False)
    def mk(**kw):
        base = dict(num_clusters=3, mus_per_cluster=1, period=1,
                    sync_mode="sparse", phi_sbs_ul=0.9, phi_mbs_dl=0.9,
                    omega_impl="fused")
        base.update(kw)
        return HFLConfig(**base)
    params = init_model(jax.random.PRNGKey(0), cfg)
    state = hfl_init(params, SGDM(), mk())
    state = state._replace(
        params=jax.tree.map(lambda p: p + 0.1 * jax.random.normal(
            jax.random.PRNGKey(p.ndim + 1), p.shape), state.params),
        eps=jax.tree.map(lambda p: 0.01 * jax.random.normal(
            jax.random.PRNGKey(p.ndim + 2), p.shape), state.eps),
        e=jax.tree.map(lambda p: 0.01 * jax.random.normal(
            jax.random.PRNGKey(p.ndim + 3), p.shape), state.e))
    save("sharded_in", state)
    mesh = Mesh(devs[:4].reshape(2, 2), ("data", "model"))
    meta = {"sharded": {}}
    for name, kw in (("sparse", {}),
                     ("q8", dict(sync_mode="quantized_sparse", wire_format="q8"))):
        h = mk(**kw)
        with mesh:
            save("sharded_" + name, jax.jit(make_sync(SyncPlan(h, mesh=mesh)))(state))
        meta["sharded"][name] = {"tiers": tiers(h), "mode": h.sync_mode,
                                 "wire": h.wire_format}

    # (pod, data, model) = (2, 2, 2): tests/test_hfl.py's shard_map setup
    mesh = Mesh(devs.reshape(2, 2, 2), ("pod", "data", "model"))
    cfg = ModelConfig(name="t", arch_type="dense", num_layers=2, d_model=32,
                      num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64,
                      dtype="float32", remat=False)
    params = init_model(jax.random.PRNGKey(0), cfg)
    pspecs = param_specs(params, data=2, model=2)
    meta["pspecs"] = [list(s) for s in jax.tree.leaves(
        pspecs, is_leaf=lambda s: isinstance(s, P))]
    def pod_cfg(**kw):
        base = dict(num_clusters=2, mus_per_cluster=2, period=2,
                    sync_mode="sparse", phi_sbs_ul=0.9, phi_mbs_dl=0.9)
        base.update(kw)
        return HFLConfig(**base)
    zero = hfl_init(params, SGDM(), pod_cfg())
    zero = zero._replace(params=jax.tree.map(lambda p: p.at[1].add(0.1), zero.params))
    rng = np.random.default_rng(3)
    noise = lambda t, sc: jax.tree.map(lambda p: p + jnp.asarray(
        sc * rng.standard_normal(p.shape).astype(np.float32)), t)
    busy = zero._replace(params=noise(zero.params, 0.05), eps=noise(zero.eps, 0.01),
                         e=noise(zero.e, 0.01))
    save("pod_in_zero", zero)
    save("pod_in_busy", busy)
    meta["pod"] = {}
    for name, kw in (("flat-topk", {}), ("flat-pallas", dict(omega_impl="pallas")),
                     ("flat-topk-bf16", dict(sync_mode="quantized_sparse")),
                     ("leaf", dict(sync_layout="leaf")),
                     ("leaf-bf16", dict(sync_layout="leaf", sync_mode="quantized_sparse")),
                     ("dense", dict(sync_mode="dense"))):
        h = pod_cfg(**kw)
        sync = jax.jit(make_sync(SyncPlan(h, mesh=mesh, param_specs=pspecs)))
        with mesh:
            for which, st in (("zero", zero), ("busy", busy)):
                save(f"pod_{name}_{which}", sync(st))
        meta["pod"][name] = {"tiers": tiers(h), "mode": h.sync_mode,
                             "wire": h.wire_format, "impl": h.omega_impl,
                             "layout": h.sync_layout}

    # rank blocks: what device_put with a NamedSharding hands each device
    coords = {int(d.id): [int(c) for c in np.argwhere(mesh.devices == d)[0]]
              for d in devs}
    meta["blocks"] = []
    x_rng = np.random.default_rng(5)
    for i, (shape, spec) in enumerate((
            ((8, 6), ("data", "model")), ((4, 8, 6), (None, "model", "data")),
            ((16,), (("data", "model"),)), ((2, 8, 4), ("pod", ("model", "data"))),
            ((2, 4, 8), ("pod", None, ("data", "model"))), ((6, 4), ()),
            ((2, 12), ("pod", None)))):
        x = x_rng.standard_normal(shape).astype(np.float32)
        arr = jax.device_put(x, NamedSharding(mesh, P(*spec)))
        out[f"block{i}|x"] = x
        for sh in arr.addressable_shards:
            out[f"block{i}|{sh.device.id}"] = np.asarray(sh.data)
        meta["blocks"].append({"shape": list(shape),
                               "spec": [s if s is None or isinstance(s, str)
                                        else list(s) for s in spec]})
    meta["coords"] = coords
    np.savez(sys.argv[1], **out)
    with open(sys.argv[2], "w") as f:
        import json; json.dump(meta, f)
    print("REF_OK")
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_ref")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(d / "ref.npz"),
                        str(d / "meta.json")], env=env, capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert "REF_OK" in r.stdout, r.stdout[-3000:] + r.stderr[-3000:]
    arrays = dict(np.load(d / "ref.npz"))
    return d, arrays, json.loads((d / "meta.json").read_text())


def _tree(arrays, prefix, field):
    """The nested dict of ``prefix|field|a/b/c`` arrays."""
    keys = sorted(k for k in arrays if k.startswith(f"{prefix}|{field}|"))
    paths = tuple(tuple(k.split("|")[2].split("/")) for k in keys)
    return tree_unflatten(paths, [arrays[k] for k in keys])


def _np_state(arrays, prefix):
    return {"params": _tree(arrays, prefix, "params"), "w_ref": _tree(arrays, prefix, "w_ref"),
            "eps": _tree(arrays, prefix, "eps"), "e": _tree(arrays, prefix, "e"),
            "opt": {"m": _tree(arrays, prefix, "opt")["m"]}, "step": 0}


def _cfg(meta_case, **kw):
    return HFLConfig(tiers=tuple(tuple(t) for t in meta_case["tiers"]),
                     sync_mode=meta_case["mode"], wire_format=meta_case["wire"], **kw)


def _assert_fields_equal(tstate, arrays, prefix, what):
    for f in FIELDS:
        want = tree_leaves(_tree(arrays, prefix, f))
        got = tree_leaves(getattr(tstate, f))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32),
                                          err_msg=f"{what}: {f}")


def _specs_tree(state, flat_specs):
    leaves, treedef = tree_flatten(state["w_ref"])
    return tree_unflatten(treedef, [P(*(tuple(e) if isinstance(e, list) else e
                                        for e in s)) for s in flat_specs])


# ---------------------------------------------------------------------------
# the rank processes (no jax here)
# ---------------------------------------------------------------------------


def _save_rank(path, rs):
    if isinstance(rs, thfl.FlatShard):
        np.savez(path, **{f: getattr(rs, f).numpy() for f in FIELDS})
        return
    out = {}
    for f in FIELDS:
        leaves, treedef = tree_flatten(getattr(rs, f))
        for p_, x in zip(treedef, leaves):
            out[f + "|" + "/".join(p_)] = x.numpy()
    np.savez(path, **out)


def _load_rank(path, like):
    z = np.load(path)
    if isinstance(like, thfl.FlatShard):
        return like._replace(**{f: torch.from_numpy(z[f]) for f in FIELDS})
    return like._replace(**{f: tree_unflatten(
        tree_flatten(getattr(like, f))[1],
        [torch.from_numpy(z[f + "|" + "/".join(p_)])
         for p_ in tree_flatten(getattr(like, f))[1]]) for f in FIELDS})


def _plan(case, specs, state, mesh=None, **kw):
    cfg = _cfg(case, omega_impl=case.get("impl", "fused"),
               sync_layout=case.get("layout", "flat"), **kw)
    pspecs = _specs_tree({"w_ref": state.w_ref}, specs) if specs else None
    return thfl.SyncPlan(cfg, mesh=mesh, param_specs=pspecs)


def rank_sync(rank, world, npz, runs, shape, specs, out, pods):
    """One rank: for each (name, input prefix, case) of ``runs``, cut its
    state from the whole one, run the mesh sync once and save its rank
    state."""
    torch.use_deterministic_algorithms(True)
    torch.set_num_threads(1)
    arrays = dict(np.load(npz))
    mesh = M.make_host_mesh(pods=pods, data=shape["data"], model=shape["model"])
    coord = M.mesh_coord(mesh)
    certs = {}
    for name, prefix, case in runs:
        state = state_from_numpy(_np_state(arrays, prefix), "cpu")
        plan = _plan(case, specs, state, mesh)
        sync = thfl.make_sync(plan)
        rs = sync(thfl.rank_state(state, plan, M.mesh_shape(mesh), coord))
        _save_rank(Path(out) / f"{name}.{rank}.npz", rs)
        certs[name] = getattr(sync, "certificates", None)
    return {"coord": coord, "certificates": certs}


def _run_all(ref, runs, shape, pods, out, specs=None):
    """Every run of ``runs`` on one set of ranks -> {name: merged state},
    the ranks' infos."""
    d, arrays, _ = ref
    world = pods * shape["data"] * shape["model"]
    kw = dict(npz=str(d / "ref.npz"), runs=runs, shape=shape, specs=specs,
              out=str(out), pods=pods)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    infos = M.run_ranks(f"{__file__}:rank_sync", world, kw, out, device="cpu",
                        timeout_s=150, env=env)
    full = dict(shape, **({"pod": pods} if pods > 1 else {}))
    merged = {}
    for name, prefix, case in runs:
        state = state_from_numpy(_np_state(arrays, prefix), "cpu")
        plan = _plan(case, specs, state)
        pieces = []
        for r, info in enumerate(infos):
            like = thfl.rank_state(state, plan, full, info["coord"])
            pieces.append((info["coord"],
                           _load_rank(Path(out) / f"{name}.{r}.npz", like)))
        merged[name] = thfl.merge_rank_states(state, plan, full, pieces)
    return merged, infos


@pytest.fixture(scope="module")
def sharded_runs(ref, tmp_path_factory):
    runs = [(w, "sharded_in", ref[2]["sharded"][w]) for w in ("sparse", "q8")]
    return _run_all(ref, runs, {"data": 2, "model": 2}, 1,
                    tmp_path_factory.mktemp("sharded_ranks"))


POD_CASES = ["flat-topk", "flat-pallas", "flat-topk-bf16", "leaf", "leaf-bf16", "dense"]


@pytest.fixture(scope="module")
def pod_runs(ref, tmp_path_factory):
    runs = [(f"{n}_{w}", f"pod_in_{w}", ref[2]["pod"][n])
            for n in POD_CASES for w in ("busy", "zero")]
    return _run_all(ref, runs, {"data": 2, "model": 2}, 2,
                    tmp_path_factory.mktemp("pod_ranks"), specs=ref[2]["pspecs"])[0]


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wire", ["sparse", "q8"])
def test_sharded_mesh_sync_equals_emulation_and_reference(ref, sharded_runs, wire):
    _, arrays, meta = ref
    merged, infos = sharded_runs[0][wire], sharded_runs[1]
    _assert_fields_equal(merged, arrays, f"sharded_{wire}", "mesh vs reference mesh")
    # the single-process emulation with 4 pieces: the same, bit for bit
    emu = thfl.make_sync(thfl.SyncPlan(_cfg(meta["sharded"][wire], omega_impl="fused",
                                            flat_shards=4)))(
        state_from_numpy(_np_state(arrays, "sharded_in"), "cpu"))
    for f in FIELDS:
        for a, b in zip(tree_leaves(getattr(merged, f)), tree_leaves(getattr(emu, f))):
            assert torch.equal(a, b), f
    assert all(i["certificates"][wire] == infos[0]["certificates"][wire] for i in infos)
    for Pm in tree_leaves(merged.params):
        assert all(torch.equal(Pm[0], Pm[n]) for n in range(1, Pm.shape[0]))


@pytest.mark.parametrize("name", POD_CASES)
def test_pod_mesh_sync_matches_reference(ref, pod_runs, name):
    _, arrays, meta = ref
    for which in ("busy", "zero"):
        merged = pod_runs[f"{name}_{which}"]
        _assert_fields_equal(merged, arrays, f"pod_{name}_{which}",
                             f"pod {name} {which}")
    # the reference test's invariants on its own state (zero buffers)
    zero = _np_state(arrays, "pod_in_zero")
    for P0, Wr0, P1, Wr1, Ep, E in zip(
            tree_leaves(zero["params"]), tree_leaves(zero["w_ref"]),
            tree_leaves(merged.params), tree_leaves(merged.w_ref),
            tree_leaves(merged.eps), tree_leaves(merged.e)):
        assert torch.equal(P1[0], P1[1])  # consensus
        np.testing.assert_allclose(P1[0].numpy(), Wr1.numpy(), rtol=1e-4,
                                   atol=1e-5)  # adoption
        if meta["pod"][name]["mode"] == "dense":
            continue
        drift = np.asarray(P0, np.float32).mean(0) - np.asarray(Wr0, np.float32)
        applied = Wr1.numpy() - np.asarray(Wr0, np.float32)
        buffered = Ep.numpy().mean(0) + E.numpy()
        np.testing.assert_allclose(applied + buffered, drift, rtol=1e-4,
                                   atol=1e-5)  # conservation


def test_rank_blocks_are_jax_blocks(ref):
    _, arrays, meta = ref
    shape = {"pod": 2, "data": 2, "model": 2}
    for i, b in enumerate(meta["blocks"]):
        spec = P(*(tuple(e) if isinstance(e, list) else e for e in b["spec"]))
        x = torch.from_numpy(arrays[f"block{i}|x"])
        for dev, c in meta["coords"].items():
            coord = dict(zip(("pod", "data", "model"), c))
            np.testing.assert_array_equal(rank_block(x, spec, shape, coord).numpy(),
                                          arrays[f"block{i}|{dev}"],
                                          err_msg=f"block {i} device {dev}")


def test_param_specs_of_the_pod_setup_equal_reference(ref):
    _, arrays, meta = ref
    tree = _np_state(arrays, "pod_in_zero")["w_ref"]
    got = [list(s) for s in tree_leaves(
        param_specs(tree_unflatten(tree_flatten(tree)[1],
                                   [torch.from_numpy(x) for x in tree_leaves(tree)]),
                    data=2, model=2))]
    assert got == meta["pspecs"]


def test_mesh_rejections():
    """The reference's rejections on a mesh, without a process group: a
    depth > 2 config, a pod mesh with no param_specs, collect_stats."""

    class FakeMesh:
        mesh_dim_names = ("pod", "data", "model")

        def size(self, i):
            return 2

    mesh = FakeMesh()
    deep = HFLConfig(tiers=((2, 1, 0.9, 0.9), (2, 2, 0.9, 0.9, 0.5, 0.2),
                            (2, 2, 0.9, 0.9, 0.5, 0.2)))
    with pytest.raises(ValueError, match="single-process only"):
        thfl.make_sync(thfl.SyncPlan(deep, mesh=mesh))
    cfg = HFLConfig(tiers=((2, 1, 0.9, 0.9), (2, 2, 0.9, 0.9, 0.5, 0.2)))
    with pytest.raises(ValueError, match="needs param_specs"):
        thfl.make_sync(thfl.SyncPlan(cfg, mesh=mesh))
    with pytest.raises(ValueError, match="collect_stats"):
        thfl.make_sync(thfl.SyncPlan(cfg, mesh=mesh, collect_stats=True))
    FakeMesh.mesh_dim_names = ("data", "model")
    fused = HFLConfig(tiers=cfg.tiers, omega_impl="fused")
    with pytest.raises(ValueError, match="collect_stats"):
        thfl.make_sync(thfl.SyncPlan(fused, mesh=mesh, collect_stats=True))
    # a pod-less mesh without fused Ω: every rank runs the local sync
    assert thfl.mesh_route(thfl.SyncPlan(cfg), {"data": 2, "model": 2}) == "local"
    assert thfl.mesh_route(thfl.SyncPlan(fused), {"data": 2, "model": 2}) == "sharded"
    assert thfl.mesh_route(thfl.SyncPlan(fused), {"data": 1, "model": 1}) == "local"


_PROD_SCRIPT = textwrap.dedent("""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch import mesh as M
    for multi, world in ((False, 256), (True, 512)):
        dist.init_process_group("fake", store=FakeStore(), rank=world - 1,
                                world_size=world)
        m = M.make_production_mesh(multi_pod=multi, device_type="cpu")
        print(M.axis_names(m), M.mesh_shape(m), M.mesh_coord(m),
              M.axis_size(m, "pod"))
        dist.destroy_process_group()
""")


def test_production_mesh_shape_with_a_fake_store():
    """256 and 512 ranks can only be built here, not run: torch's fake
    process group (``FakeStore``) gives the mesh its shape and names."""
    r = subprocess.run([sys.executable, "-c", _PROD_SCRIPT], capture_output=True,
                       text=True, timeout=120, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 2, r.stdout + r.stderr
    assert lines[0] == ("('data', 'model') {'data': 16, 'model': 16} "
                        "{'data': 15, 'model': 15} 1")
    assert lines[1] == ("('pod', 'data', 'model') {'pod': 2, 'data': 16, "
                        "'model': 16} {'pod': 1, 'data': 15, 'model': 15} 2")


def test_mesh_entry_points_ask_for_the_card():
    """A rank joins on the card unless the caller names the CPU: without
    CUDA that raises before any group is made."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_process_group(0, 1, M.free_port())


def test_run_ranks_reports_a_failing_rank(tmp_path):
    with pytest.raises(RuntimeError, match=r"rank 1 failed \(exit 3\)"):
        M.run_ranks(f"{__file__}:_fail_on_rank_1", 2, {}, tmp_path, device="cpu",
                    timeout_s=60, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))


def _fail_on_rank_1(rank, world):
    if rank == 1:
        raise SystemExit(3)
    return rank
