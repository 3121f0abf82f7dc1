"""The dry-run of the port (``repro_torch.launch.dryrun``) against the
reference's, whose programs XLA compiles in one subprocess on 8 faked host
devices (``--xla_force_host_platform_device_count=8``; optimization off,
which changes no argument size).

For reduced olmo-1b (dense), deepseek-v2 (MoE, MLA) and llava-next (a
frontend), on (data, model) = (2, 2) and (pod, data, model) = (2, 2, 2):
  * every input leaf's shape, dtype and spec equals the reference's
    (``train_input_specs``, ``serve_input_specs``, ``cache_out_shardings``);
  * ``memory.argument_bytes`` equals the reference's compiled
    ``memory_analysis().argument_size_in_bytes`` exactly, for
    ``train_step``, ``sync_step``, ``prefill_step`` and ``serve_step``;
  * the ``sync_step``'s collectives equal the reference's (``hlo_cost``'s
    trip-count-aware count of the compiled sync), and, as a second witness,
    the all-gather bytes the port's own pod-mesh sync hands to gloo, 8
    rank processes on the CPU;
  * the numbers the port cannot take from a partitioned program are None
    under the reference's keys (``cost.flops``, the model steps'
    ``collectives``), with a note; the port's own flops stand under
    ``cost.flops_unpartitioned`` / ``flops_global``.
Also ``INPUT_SHAPES``, the ``long_500k`` skip rule and the CLI. Tolerance:
none; every comparison is exact.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.configs import INPUT_SHAPES, get_config, get_shape
from repro_torch.configs.base import HFLConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as st
from repro_torch.utils.tree import jax_leaves

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("olmo-1b", "deepseek-v2-236b", "llava-next-34b")
MESHES = ((2, 2), (2, 2, 2))
SHAPES = ("train_4k", "prefill_32k", "decode_32k")

_REF_SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               "--xla_backend_optimization_level=0 "
                               "--xla_llvm_disable_expensive_passes=true")
    import jax, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.configs import INPUT_SHAPES, get_config, get_shape
    from repro.configs.base import HFLConfig
    from repro.launch import steps as st
    from repro.launch.hlo_cost import analyze

    def specs(tree):
        out = []
        for l in jax.tree.leaves(tree):
            spec = [e if e is None or isinstance(e, str) else list(e)
                    for e in l.sharding.spec]
            out.append([list(l.shape), str(l.dtype), spec])
        return out

    def cache_specs(tree):
        return [[e if e is None or isinstance(e, str) else list(e) for e in s.spec]
                for s in jax.tree.leaves(tree)]

    devs = np.array(jax.devices())
    out = {"shapes": {k: [v.seq_len, v.global_batch, v.kind]
                      for k, v in INPUT_SHAPES.items()}}
    for arch in sys.argv[2].split(","):
        cfg = get_config(arch).reduced()
        for mshape in ((2, 2), (2, 2, 2)):
            axes = ("data", "model") if len(mshape) == 2 else ("pod", "data", "model")
            mesh = Mesh(devs[:int(np.prod(mshape))].reshape(mshape), axes)
            data, pods = mesh.shape["data"], mesh.shape.get("pod", 1)
            hfl = HFLConfig(num_clusters=pods, mus_per_cluster=data, period=4,
                            sync_mode="sparse")
            rec = out[f"{arch}|{len(mshape)}"] = {}
            with mesh:
                shape = get_shape("train_4k")
                state_sds, batch_sds, pspecs = st.train_input_specs(cfg, shape, mesh, hfl)
                rec["train_specs"] = specs((state_sds, batch_sds))
                bax = ("data",) if (shape.global_batch // pods) % data == 0 else None
                step = st.build_train_step(cfg, groups=data, batch_axes=bax)
                c = jax.jit(step).lower(state_sds, batch_sds).compile()
                rec["train_step"] = c.memory_analysis().argument_size_in_bytes
                rec["train_coll"] = analyze(c.as_text())["coll"]
                if pods > 1:
                    c = jax.jit(st.build_sync_step(hfl, mesh, pspecs)).lower(state_sds).compile()
                    rec["sync_step"] = c.memory_analysis().argument_size_in_bytes
                    cost = analyze(c.as_text())
                    rec["sync_coll"], rec["sync_flops"] = cost["coll"], cost["flops"]
                shape = get_shape("prefill_32k")
                sds = st.serve_input_specs(cfg, shape, mesh, mode="prefill")
                rec["prefill_specs"] = specs(sds)
                groups = data if shape.global_batch % data == 0 else 1
                bax = ("data",) if shape.global_batch % data == 0 else None
                outs = st.cache_out_shardings(cfg, shape, mesh)
                rec["cache_out_specs"] = cache_specs(outs)
                c = jax.jit(st.build_prefill_step(cfg, groups=groups, batch_axes=bax),
                            out_shardings=(None, outs)).lower(*sds).compile()
                rec["prefill_step"] = c.memory_analysis().argument_size_in_bytes
                shape = get_shape("decode_32k")
                sds = st.serve_input_specs(cfg, shape, mesh, mode="decode")
                rec["decode_specs"] = specs(sds)
                bax = ("data",) if shape.global_batch % data == 0 else None
                c = jax.jit(st.build_decode_step(cfg, groups=1, batch_axes=bax)
                            ).lower(*sds).compile()
                rec["serve_step"] = c.memory_analysis().argument_size_in_bytes
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
    print("REF_OK")
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun_ref") / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(path), ",".join(ARCHS)],
                       env=env, capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert "REF_OK" in r.stdout, r.stdout[-3000:] + r.stderr[-3000:]
    return json.loads(path.read_text())


def _hfl(mshape):
    return HFLConfig(num_clusters=mshape[0] if len(mshape) == 3 else 1,
                     mus_per_cluster=mshape[-2], period=4, sync_mode="sparse")


def _specs(*trees):
    return [[list(l.shape), str(l.dtype).removeprefix("torch."),
             [e if e is None or isinstance(e, str) else list(e) for e in l.spec]]
            for t in trees for l in jax_leaves(t)]


@pytest.mark.parametrize("mshape", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_specs_match_the_reference(ref, arch, mshape):
    want = ref[f"{arch}|{len(mshape)}"]
    cfg = get_config(arch).reduced()
    with D.fake_world(len(mshape) and int(torch.tensor(mshape).prod())):
        mesh = M.make_host_mesh(pods=mshape[0] if len(mshape) == 3 else 1,
                                data=mshape[-2], model=mshape[-1], device_type="cpu")
        state_sds, batch_sds, _ = st.train_input_specs(cfg, get_shape("train_4k"),
                                                       mesh, _hfl(mshape))
        prefill = st.serve_input_specs(cfg, get_shape("prefill_32k"), mesh, mode="prefill")
        decode = st.serve_input_specs(cfg, get_shape("decode_32k"), mesh, mode="decode")
        outs = st.cache_out_shardings(cfg, get_shape("prefill_32k"), mesh)
    assert _specs(state_sds, batch_sds) == want["train_specs"]
    assert _specs(*prefill) == want["prefill_specs"]
    assert _specs(*decode) == want["decode_specs"]
    assert [[e if e is None or isinstance(e, str) else list(e) for e in s.spec]
            for s in jax_leaves(outs)] == want["cache_out_specs"]


@pytest.mark.parametrize("mshape", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_xla(ref, arch, mshape):
    want = ref[f"{arch}|{len(mshape)}"]
    cfg = get_config(arch).reduced()
    got = {}
    for shape in SHAPES:
        rec = D.dryrun_pair(arch, shape, multi_pod=len(mshape) == 3, cfg=cfg,
                            mesh_shape=mshape, verbose=False)
        assert rec["status"] == "ok"
        for name, r in rec["programs"].items():
            got[name] = r["memory"]["argument_bytes"]
            assert r["memory"]["temp_bytes"] is None and r["notes"]
            assert r["n_devices"] == int(torch.tensor(mshape).prod())
            assert r["cost"]["flops"] is None
            assert (r["cost"]["flops_unpartitioned"] * r["n_devices"]
                    == r["cost"]["flops_global"])
    names = ["train_step", "prefill_step", "serve_step"] + (["sync_step"]
                                                           if len(mshape) == 3 else [])
    assert got == {n: want[n] for n in names}


@pytest.mark.parametrize("arch", ARCHS)
def test_collectives_match_the_reference(ref, arch):
    """The sync's collectives are the reference's exactly; the train step's
    are the partitioner's in the reference (nonzero), so the port, which
    has none, reports None with a note rather than a number."""
    want = ref[f"{arch}|3"]
    rec = D.dryrun_pair(arch, "train_4k", multi_pod=True, cfg=get_config(arch).reduced(),
                        mesh_shape=(2, 2, 2), verbose=False)
    sync, train = rec["programs"]["sync_step"], rec["programs"]["train_step"]
    assert sync["collectives"] == {k: {"bytes": int(v)}
                                   for k, v in want["sync_coll"].items()}
    assert sync["collectives"]["all-gather"]["bytes"] > 0
    assert want["sync_flops"] == sync["cost"]["flops_global"] == 0.0
    assert want["train_coll"] and train["collectives"] is None
    assert any("collectives is None" in n for n in train["notes"])
    assert not any("collectives is None" in n for n in sync["notes"])
    assert any("cost.flops is None" in n for n in sync["notes"])


def _rank_sync_bytes(rank, world):
    """One rank of (pod, data, model) = (2, 2, 2): its blocks of a seeded
    reduced olmo-1b state, one pod-mesh sync with the dry-run's config;
    -> the bytes its all-gathers handed to gloo."""
    from repro_torch.core import hfl as H
    from repro_torch.launch import sharding as S
    from repro_torch.models.transformer import init_model

    mesh = M.make_host_mesh(pods=2, data=2, model=2)
    cfg = get_config("olmo-1b").reduced()
    hfl = _hfl((2, 2, 2))
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    pspecs = S.param_specs(params, data=2, model=2)
    plan = H.SyncPlan(hfl, mesh=mesh, param_specs=pspecs)
    state = H.hfl_init(params, st.default_optimizer(), hfl)
    local = H.rank_state(state, plan, M.mesh_shape(mesh), M.mesh_coord(mesh))
    sizes = []
    M.gather_observers.append(lambda axis, nbytes: sizes.append(nbytes))
    H.make_sync(plan)(local)
    return {"bytes": sum(sizes), "calls": len(sizes)}


def test_sync_collectives_equal_the_gloo_run(tmp_path):
    rec = D.dryrun_pair("olmo-1b", "train_4k", multi_pod=True,
                        cfg=get_config("olmo-1b").reduced(), mesh_shape=(2, 2, 2),
                        verbose=False)
    got = rec["programs"]["sync_step"]["collectives"]
    ranks = M.run_ranks(f"{__file__}:_rank_sync_bytes", 8, {}, tmp_path, device="cpu",
                        timeout_s=240, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert len({r["bytes"] for r in ranks}) == 1 and ranks[0]["calls"] == 2
    assert got == {"all-gather": {"bytes": ranks[0]["bytes"]}}


def test_input_shapes_and_the_long_context_skip(ref):
    assert {k: [v.seq_len, v.global_batch, v.kind]
            for k, v in INPUT_SHAPES.items()} == ref["shapes"]
    with pytest.raises(KeyError, match="unknown shape"):
        get_shape("train_8k")
    rec = D.dryrun_pair("olmo-1b", "long_500k", multi_pod=False, verbose=False)
    assert rec == {"arch": "olmo-1b", "shape": "long_500k", "multi_pod": False,
                   "status": "skipped", "reason": "full-attention arch; see DESIGN.md §4"}
    for arch, sub in (("mamba2-780m", True), ("zamba2-7b", True),
                      ("h2o-danube-3-4b", True), ("granite-34b", False)):
        assert get_config(arch).subquadratic == sub
    rec = D.dryrun_pair("mamba2-780m", "long_500k", multi_pod=True,
                        cfg=get_config("mamba2-780m").reduced(), verbose=False)
    assert rec["status"] == "ok" and set(rec["programs"]) == {"serve_step"}


def test_cli_runs_on_the_production_meshes(tmp_path):
    out = tmp_path / "dry.json"
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                        "olmo-1b", "--shape", "train_4k", "--both-meshes", "--out",
                        str(out)], capture_output=True, text=True, timeout=300,
                       cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    lines = [l for l in r.stdout.splitlines() if l.startswith("[dryrun]")]
    assert lines == ["[dryrun] olmo-1b x train_4k x 1pod/256",
                     "[dryrun] olmo-1b x train_4k x 1pod/256 -> ok",
                     "[dryrun] olmo-1b x train_4k x 2pod/512",
                     "[dryrun] olmo-1b x train_4k x 2pod/512 -> ok",
                     "[dryrun] done: 2 ok, 0 errors"]
    recs = json.loads(out.read_text())
    assert [r["programs"]["train_step"]["n_devices"] for r in recs] == [256, 512]
    assert set(recs[1]["programs"]) == {"train_step", "sync_step"}
    assert recs[1]["programs"]["sync_step"]["collectives"]["all-gather"]["bytes"] > 0
