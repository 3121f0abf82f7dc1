"""Guards of the PyTorch port: it imports nothing of the JAX package, nor
``ml_dtypes`` (the card machine has none) or ``msgpack`` (the checkpoint
format is encoded by hand), its entry points (the training CLI, the
paper-exact path) run on the CPU when asked, and nothing falls back to the
CPU when the card was asked for."""
import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax", "optax",
                                  "ml_dtypes", "msgpack")]
    assert not bad, f"{path} imports {bad}"


def test_cli_runs_on_cpu_when_asked():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "4", "--tiers", "2x2:H=2", "--batch-per-mu", "2",
         "--seq", "16", "--omega-impl", "fused"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    last = res.stdout.strip().splitlines()[-1]
    assert last.startswith("[train] first-loss=") and "eval-loss=" in last


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less path")
    from repro_torch.configs import get_config
    from repro_torch.device import resolve
    from repro_torch.launch import train
    from repro_torch.models.transformer import init_model
    from repro_torch.utils.convert import params_from_numpy

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve()
    with pytest.raises(RuntimeError, match="CUDA"):
        train.run(train.parse_args(["--steps", "1"]))  # --device defaults to cuda
    with pytest.raises(RuntimeError, match="CUDA"):  # an async scenario too
        train.run(train.parse_args(["--scenario", "async", "--steps", "2"]))
    cfg = get_config("olmo-1b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"w": np.zeros((2, 2), np.float32)})
    assert resolve("cpu").type == "cpu"
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert params["embed"].device.type == "cpu"


def test_serving_twin_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less path")
    from repro_torch.launch import serve_batched
    from repro_torch.models.transformer import init_cache

    cfg = serve_batched.get_config("mamba2-780m").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_batched.run("mamba2-780m")  # device defaults to cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_batched.main(["--arch", "zamba2-7b"])
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(cfg, 2, 8)
    assert init_cache(cfg, 2, 8, device="cpu")["state"].device.type == "cpu"


def test_paper_path_raises_without_a_card_and_runs_on_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less path")
    from repro_torch.launch import paper_accuracy as pa
    from repro_torch.models.resnet import init_resnet18

    hfl = pa.paper_hfl(2, 2, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        pa.run("x", hfl, 1)  # device defaults to cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        init_resnet18(torch.Generator().manual_seed(0))
    params, state = init_resnet18(torch.Generator().manual_seed(0), width=0.125,
                                  device="cpu")
    assert params["conv0"].device.type == state["bn0"]["mean"].device.type == "cpu"
    out = pa.run("x", hfl, 2, batch_per_mu=2, width=0.125, device="cpu",
                 omega_impl="pallas")
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert 0.0 <= out["acc"] <= 1.0


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_faithful_state_stays_on_w0_device(device):
    from repro_torch.configs.base import HFLConfig
    from repro_torch.core.federated import FaithfulHFL

    sim = FaithfulHFL(w0=torch.zeros(64, device=device), grad_fn=lambda w, b: b,
                      hfl_cfg=HFLConfig(tiers=((2, 1, 0.9, 0.9), (3, 2, 0.9, 0.9))),
                      lr_schedule=lambda t: 0.1)
    for key, t in sim.state.items():
        if key != "t":
            assert t.device.type == device, key
    assert sim.state["u"].shape == (6, 64) and sim.state["w_tilde_n"].shape == (3, 64)


def test_comm_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less path")
    from repro_torch.comm.codecs import get_codec
    from repro_torch.kernels.bitpack import ops as bops
    from repro_torch.launch import comm_bits

    v, i = np.ones(3, np.float32), np.array([1, 5, 9], np.int32)
    for name in ("bitmap", "bitmap-q8"):
        with pytest.raises(RuntimeError, match="CUDA"):
            get_codec(name).encode(v, i, 16, impl="pallas")  # device: cuda
        np.testing.assert_array_equal(
            get_codec(name).encode(v, i, 16, impl="pallas", device="cpu"),
            get_codec(name).encode(v, i, 16))
    x = np.array([0.0, 2.0, 0.0, -1.0], np.float32)
    for fn in (bops.bitpack_bytes, bops.bitmap_payload):  # numpy: device rule
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(x)
    assert bops.bitpack_bytes(x, device="cpu") == b"\x0a"
    packed, vals = bops.bitmap_payload(x, device="cpu")
    assert packed == b"\x0a" and vals.tolist() == [2.0, -1.0]
    with pytest.raises(RuntimeError, match="CUDA"):
        comm_bits.run(1024)
    _, art = comm_bits.run(1024, device="cpu")
    assert art["device"] == "cpu" and art["sparse_codecs_beating_analytic_at_0.99"]


def test_unported_flags_raise():
    """No flag of the reference's train CLI is left unported: the port's
    parser takes every one, and the last that raised, ``--ckpt-dir``, now
    writes ``ckpt_{steps:08d}.msgpack`` after eval and logs a
    ``checkpoint`` event."""
    import re
    import tempfile

    from repro.launch import train as jtrain
    from repro_torch.launch import train

    flags = lambda path: set(re.findall(r'add_argument\("(--[a-z0-9-]+)"',
                                        Path(path).read_text()))
    missing = flags(jtrain.__file__) - flags(train.__file__)
    assert not missing, missing
    with tempfile.TemporaryDirectory() as d:
        log = Path(d) / "run.jsonl"
        train.run(train.parse_args(["--ckpt-dir", d, "--device", "cpu", "--steps", "4",
                                    "--tiers", "2x1:H=2", "--batch-per-mu", "1",
                                    "--seq", "8", "--metrics-out", str(log)]))
        assert sorted(p.name for p in Path(d).glob("ckpt_*")) == ["ckpt_00000004.msgpack"]
        events = [json.loads(l) for l in log.read_text().splitlines()]
        ck = [e for e in events if e.get("event") == "checkpoint"]
        assert len(ck) == 1 and ck[0]["path"] == str(Path(d) / "ckpt_00000004.msgpack")
    # the sharded flat vector is ported: a short run completes
    out = train.run(train.parse_args(["--flat-shards", "2", "--omega-impl", "fused",
                                      "--device", "cpu", "--steps", "2",
                                      "--tiers", "2x1:H=2", "--batch-per-mu", "1",
                                      "--seq", "8"]))
    assert len(out["hist"]) == 2 and len(out["sync_s"]) == 1


@pytest.mark.parametrize("argv,message", [
    (["--clusters", "0"], "fanout must be >= 1"),
    (["--mus", "0"], "fanout must be >= 1"),
    (["--period", "0"], "period must be >= 1"),
])
def test_zero_valued_legacy_flags_are_rejected_by_both_clis(argv, message):
    """``--clusters/--mus/--period 0`` reach ``parse_tiers_spec`` as given
    (``0x2:H=4``, ``4x0:H=4``, ``4x2:H=0``) in both CLIs, which reject
    them, and never run as the defaults 4 / 2 / 4."""
    from repro.configs.base import _reset_legacy_hfl_warnings as j_reset
    from repro.launch import train as jtrain
    from repro_torch.configs.base import _reset_legacy_hfl_warnings
    from repro_torch.launch import train

    runs = ((j_reset, lambda: jtrain.main(argv + ["--steps", "1"])),
            (_reset_legacy_hfl_warnings, lambda: train.run(train.parse_args(
                argv + ["--steps", "1", "--device", "cpu"]))))
    for reset, run in runs:
        reset()
        with pytest.warns(DeprecationWarning, match=f"{argv[0]} is deprecated; use "
                          "--tiers CLUSTERSxMUS:H=PERIOD"):
            with pytest.raises(ValueError, match=message):
                run()


def test_legacy_flag_runs_with_a_deprecation_warning():
    from repro_torch.configs.base import _reset_legacy_hfl_warnings
    from repro_torch.launch import train

    _reset_legacy_hfl_warnings()
    with pytest.warns(DeprecationWarning, match="--period is deprecated"):
        out = train.run(train.parse_args(["--clusters", "2", "--mus", "1", "--period", "2",
                                          "--device", "cpu", "--steps", "2",
                                          "--batch-per-mu", "1", "--seq", "8"]))
    assert len(out["hist"]) == 2 and len(out["sync_s"]) == 1


def test_package_surfaces_match_the_reference():
    """``__all__`` of the port's ``obs``, ``comm`` and ``wireless`` is the
    reference's (``repro.wireless`` has none: its public names are what it
    imports from its submodules). ``core``, ``models``, ``utils``,
    ``checkpoint``, ``kernels.fused_sync`` and ``kernels.dgc`` export the
    reference's public names too, and its submodules (``utils.jaxcompat``
    has no counterpart: it routes jax's version drift)."""
    import importlib
    import types

    import repro.comm
    import repro.obs
    import repro.wireless
    import repro_torch.comm
    import repro_torch.obs
    import repro_torch.wireless

    assert repro_torch.obs.__all__ == repro.obs.__all__
    assert repro_torch.comm.__all__ == repro.comm.__all__
    public = sorted(n for n, v in vars(repro.wireless).items()
                    if not n.startswith("_") and not isinstance(v, types.ModuleType))
    assert sorted(repro_torch.wireless.__all__) == public
    for pkg in (repro_torch.obs, repro_torch.comm, repro_torch.wireless):
        assert all(hasattr(pkg, n) for n in pkg.__all__)

    def names(pkg, modules):
        return sorted(n for n, v in vars(pkg).items() if not n.startswith("_")
                      and isinstance(v, types.ModuleType) == modules
                      and n not in ("annotations", "jaxcompat"))

    for name in ("core", "models", "utils", "checkpoint", "kernels.fused_sync",
                 "kernels.dgc"):
        ref = importlib.import_module(f"repro.{name}")
        port = importlib.import_module(f"repro_torch.{name}")
        assert names(port, False) == names(ref, False), name
        assert set(names(ref, True)) <= set(names(port, True)), name


def test_legacy_hfl_keywords_and_read_shims_match_the_reference():
    """``HFLConfig(num_clusters=4, period=2)`` builds the reference's tiers,
    ``dataclasses.replace(cfg, period=3)`` goes through the same shim, and
    each deprecated read gives the reference's value and warning, once."""
    import dataclasses
    import warnings

    from repro.configs import base as jb
    from repro_torch.configs import base as tb

    kw = dict(num_clusters=4, mus_per_cluster=3, period=2, phi_mu_ul=0.95,
              phi_sbs_dl=0.8, phi_sbs_ul=0.85, phi_mbs_dl=0.7, beta_s=0.4, beta_m=0.3)
    cases = [({"num_clusters": 4, "period": 2}, None), (kw, None),
             ({"period": 3}, {"omega_impl": "fused", "sync_mode": "dense"})]
    for legacy, extra in cases:
        j, t = jb.HFLConfig(**legacy, **(extra or {})), tb.HFLConfig(**legacy, **(extra or {}))
        assert [dataclasses.astuple(x) for x in t.tiers] == \
               [dataclasses.astuple(x) for x in j.tiers]
        assert (t.omega_impl, t.sync_mode) == (j.omega_impl, j.sync_mode)
        jr, tr = dataclasses.replace(j, period=5), dataclasses.replace(t, period=5)
        assert tr.tiers[1].period == jr.tiers[1].period == 5

    def reads(mod):
        mod._reset_legacy_hfl_warnings()
        cfg = mod.HFLConfig(**kw)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            vals = [getattr(cfg, f) for f in kw for _ in range(2)]  # each read twice
        return vals, [str(w.message) for w in caught if w.category is DeprecationWarning]

    vals, msgs = reads(tb)
    assert (vals, msgs) == reads(jb)
    assert len(msgs) == 7  # the 7 deprecated reads, once each
    with pytest.raises(TypeError, match="unexpected keyword"):
        tb.HFLConfig(clusters=4)
    deep = tb.parse_tiers_spec("2x2x4:H=2,2")
    with pytest.raises(ValueError, match="ambiguous on a depth-3"):
        tb.HFLConfig(tiers=deep, period=2)
    with pytest.raises(AttributeError, match="depth-3"):
        tb.HFLConfig(tiers=deep).period


def test_make_sync_step_warns_once_and_builds_the_same_sync():
    import warnings

    from repro.core import hfl as jhfl
    from repro_torch.configs.base import HFLConfig
    from repro_torch.core import hfl as thfl
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    from repro_torch.optim import SGDM
    from repro_torch.utils.tree import tree_leaves

    from repro.configs.base import HFLConfig as JHFLConfig

    msgs = []
    for mod, cfg in ((jhfl, JHFLConfig(num_clusters=2, mus_per_cluster=1, period=2)),
                     (thfl, HFLConfig(num_clusters=2, mus_per_cluster=1, period=2))):
        mod._make_sync_step_warned = False
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            mod.make_sync_step(cfg)
            mod.make_sync_step(cfg)
        msgs.append([str(w.message) for w in caught if w.category is DeprecationWarning])
    assert msgs[0] == msgs[1] and len(msgs[1]) == 1
    hfl = HFLConfig(num_clusters=2, mus_per_cluster=1, period=2, phi_sbs_ul=0.9,
                    phi_mbs_dl=0.9)
    params = init_model(torch.Generator().manual_seed(0), get_config("olmo-1b").reduced(),
                        device="cpu")
    states = []
    for build in (lambda: thfl.make_sync_step(hfl),
                  lambda: thfl.make_sync(thfl.SyncPlan.from_config(hfl))):
        state = thfl.hfl_init(params, SGDM(), hfl)
        gen = torch.Generator().manual_seed(1)
        for p in tree_leaves(state.params):
            p.add_(0.01 * torch.randn(p.shape, generator=gen).to(p.dtype))
        states.append(build()(state))
    for a, b in zip(tree_leaves(states[0]._asdict()), tree_leaves(states[1]._asdict())):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b


def test_tree_helpers_match_the_reference():
    """``param_count`` / ``param_bytes`` exact, ``tree_add`` / ``tree_scale``
    / ``tree_zeros_like`` exact, on the same weights. ``global_norm``: the
    port within rtol 1e-6 of the exact (f64) norm; the reference's XLA-CPU
    f32 reduction of a 131k-entry leaf is off by ~4e-6 of it here (the two
    sum in different orders), so port against reference at rtol 1e-5."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.models.transformer import init_model as j_init
    from repro.utils import tree as jt
    from repro_torch.utils import tree as tt
    from repro_torch.utils.convert import params_from_numpy

    jp = j_init(jax.random.PRNGKey(0), j_get_config("olmo-1b").reduced())
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert tt.param_count(tp) == jt.param_count(jp)
    assert tt.param_bytes(tp) == jt.param_bytes(jp)
    exact = np.sqrt(sum(np.sum(np.asarray(x, np.float64) ** 2)
                        for x in jax.tree.leaves(jp)))
    np.testing.assert_allclose(float(tt.global_norm(tp)), exact, rtol=1e-6)
    np.testing.assert_allclose(float(tt.global_norm(tp)), float(jt.global_norm(jp)),
                               rtol=1e-5)
    f32 = lambda t: jax.tree.map(lambda x: x.astype(jnp.float32), t)
    jf, tf = f32(jp), tt.tree_map(lambda x: x.float(), tp)
    for jx, tx in ((jt.tree_add(jf, jf), tt.tree_add(tf, tf)),
                   (jt.tree_scale(jf, 0.5), tt.tree_scale(tf, 0.5)),
                   (jt.tree_zeros_like(jp), tt.tree_zeros_like(tp))):
        for a, b in zip(jax.tree.leaves(jx), tt.tree_leaves(tx), strict=True):
            np.testing.assert_array_equal(np.asarray(a, np.float32), b.float().numpy())
    assert float(tt.global_norm({})) == 0.0


def test_kernel_wrappers_check_their_operands():
    from repro_torch.kernels.dgc import kernel as DK
    from repro_torch.kernels.fused_sync import kernel as FK

    th = torch.tensor([0.5])
    with pytest.raises(ValueError):
        FK.block_select(torch.zeros(10, dtype=torch.float64), th, 8, 10)
    with pytest.raises(ValueError):
        FK.block_select(torch.zeros(10), th, 0, 10)
    with pytest.raises(ValueError):  # th is a tensor on x's device, not a float
        FK.block_select(torch.zeros(10), 0.5, 8, 10)
    bad = torch.zeros(100, 1024)  # rows not a multiple of 256
    with pytest.raises(ValueError):
        DK.update_max(bad, bad, bad, 0.5)
    ok = torch.zeros(256, 1024)
    with pytest.raises(ValueError):
        DK.tail_hist(ok, torch.zeros(300))
    th = torch.tensor(0.5)
    with pytest.raises(ValueError):  # rows not a multiple of 256
        DK.apply_mask(bad, bad, th)
    with pytest.raises(ValueError):
        DK.apply_mask(ok.double(), ok.double(), th)
    with pytest.raises(ValueError):  # th is a tensor on u's device, not a float
        DK.apply_mask(ok, ok, 0.5)
    with pytest.raises(ValueError):
        DK.apply_mask(ok, torch.zeros(512, 1024), th)
    assert all(t.shape == ok.shape for t in DK.apply_mask(ok, ok, th))
    from repro_torch.kernels.bitpack import kernel as BK

    with pytest.raises(ValueError):  # dtype
        BK.bitpack(ok.double())
    with pytest.raises(ValueError):  # rows not a multiple of 256
        BK.bitpack(bad)
    with pytest.raises(ValueError):  # not [R, 1024]
        BK.bitpack(torch.zeros(256, 512))
    with pytest.raises(ValueError):  # not contiguous
        BK.bitpack(torch.zeros(1024, 256).t())
    with pytest.raises(ValueError):  # device
        BK.bitpack(torch.zeros(256, 1024, device="meta"))
    out, counts = BK.bitpack(ok)
    assert out.shape == (256, 128) and counts.shape == (1, 1)
    from repro_torch.kernels.decode_attn import kernel as DA

    q, kv = torch.zeros(2, 1, 4, 16), torch.zeros(2, 8, 2, 16)
    sp, qp = torch.zeros(2, 8, dtype=torch.int64), torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError):  # dtype
        DA.decode_attn(q.double(), kv.double(), kv.double(), sp, qp)
    with pytest.raises(ValueError):  # slot_pos not int64
        DA.decode_attn(q, kv, kv, sp.int(), qp)
    with pytest.raises(ValueError):  # the cache not contiguous
        DA.decode_attn(q, kv.transpose(0, 1).contiguous().transpose(0, 1), kv, sp, qp)
    assert DA.decode_attn(q, kv, kv, sp, qp).shape == q.shape
    qa, lat = torch.zeros(2, 4, 32), torch.zeros(2, 8, 32)
    qr, kr = torch.zeros(2, 4, 8), torch.zeros(2, 8, 8)
    with pytest.raises(ValueError):  # kr's width is not q_rope's
        DA.mla_decode_attn(qa, qr, lat, lat, sp, qp, qk_head_dim=24)
    assert DA.mla_decode_attn(qa, qr, lat, kr, sp, qp, qk_head_dim=24).shape == qa.shape


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:  # a directory holding chip_smoke.py and nothing else
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    res = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=120, cwd=cwd,
                         env={"PATH": "/usr/bin:/bin"})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_attention_wrapper_launches_its_kernel_for_cuda_tensors(monkeypatch):
    """``flash_attention`` and the backward's wrapper on CUDA tensors (fake
    ones: no card here) go to the kernels' C entries, stubbed, with the
    problem's sizes, and count one launch each call; a failed launch or a
    library that cannot be built raises: nothing falls back to the plain
    version."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn import kernel as FA
    from repro_torch.models.attention import flash_attention

    calls, rc = [], [0]

    class Stub:
        def rt_flash_attn_fwd(self, *args):
            calls.append(("fwd", args[5:-1]))
            return rc[0]

        def rt_flash_attn_bwd(self, *args):
            calls.append(("bwd", args[10:-1]))
            return rc[0]

    monkeypatch.setattr(_build, "library", Stub)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    fwd0, bwd0 = FA.flash_attn_fwd.launches, FA.flash_attn_bwd.launches

    def attend(dtype=torch.bfloat16):
        with FakeTensorMode():
            q = torch.empty(2, 64, 4, 24, device="cuda", dtype=dtype)
            k = torch.empty(2, 64, 2, 24, device="cuda", dtype=dtype)
            v = torch.empty(2, 64, 2, 16, device="cuda", dtype=dtype)
            out = flash_attention(q, k, v, window=8)
            o32, lse = FA.flash_attn_fwd(q, k, v, window=8)
            grads = FA.flash_attn_bwd(q, k, v, o32, lse, torch.empty_like(out), window=8)
            return out, grads

    out, grads = attend()
    assert out.shape == (2, 64, 4, 16) and out.dtype == torch.bfloat16
    assert [g.shape for g in grads] == [(2, 64, 4, 24), (2, 64, 2, 24), (2, 64, 2, 16)]
    scale = 1.0 / np.sqrt(24)
    sizes = (2, 64, 64, 4, 2, 24, 16, 0, 8)
    assert [c[0] for c in calls] == ["fwd", "fwd", "bwd"]
    for _, args in calls:
        assert args[:9] == sizes and args[9] == pytest.approx(scale) and args[10] == 1
    assert (FA.flash_attn_fwd.launches, FA.flash_attn_bwd.launches) == (fwd0 + 2, bwd0 + 1)
    rc[0] = 719  # cudaErrorLaunchFailure
    with pytest.raises(RuntimeError, match="flash_attn_fwd failed to launch"):
        attend(torch.float32)

    def unbuildable():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "library", unbuildable)
    with pytest.raises(RuntimeError, match="nvcc"):
        attend()


def test_decode_wrappers_launch_their_kernels_for_cuda_tensors(monkeypatch):
    """``decode_attention`` and ``mla_decode``'s latent part on CUDA tensors
    (fake ones: no card here) go to the kernels' C entries, stubbed, with
    the problem's sizes and a workspace of the splits, and count one launch
    each call on the kernel the route picks (bf16 G = 4 and bf16 MLA: the
    tensor-core entries; f32: the CUDA-core ones); a failed launch or a
    library that cannot be built raises: nothing falls back to the other
    kernel or the plain version."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attn import kernel as DA
    from repro_torch.models.attention import decode_attention

    calls, rc = [], [0]

    class Stub:
        def rt_decode_attn(self, *args):
            calls.append(("gqa", args[8:-1]))
            return rc[0]

        def rt_mla_decode_attn(self, *args):
            calls.append(("mla", args[9:-1]))
            return rc[0]

        def rt_decode_attn_tc(self, *args):
            calls.append(("gqa tc", args[8:-1]))
            return rc[0]

        def rt_mla_decode_attn_tc(self, *args):
            calls.append(("mla tc", args[9:-1]))
            return rc[0]

    monkeypatch.setattr(_build, "library", Stub)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    counters = (DA.decode_attn, DA.mla_decode_attn, DA.decode_attn_tc,
                DA.mla_decode_attn_tc)
    launches = [fn.launches for fn in counters]

    def attend(dtype=torch.bfloat16):
        with FakeTensorMode():
            sp = torch.empty(2, 4096, dtype=torch.int64, device="cuda")
            qp = torch.empty(2, dtype=torch.int64, device="cuda")
            q = torch.empty(2, 1, 8, 120, device="cuda", dtype=dtype)
            kv = torch.empty(2, 4096, 2, 120, device="cuda", dtype=dtype)
            out = decode_attention(q, kv, kv, sp, qp, window=4096)
            lat = DA.mla_decode_attn(torch.empty(2, 40, 64, device="cuda", dtype=dtype),
                                     torch.empty(2, 40, 16, device="cuda", dtype=dtype),
                                     torch.empty(2, 4096, 64, device="cuda", dtype=dtype),
                                     torch.empty(2, 4096, 16, device="cuda", dtype=dtype),
                                     sp, qp, qk_head_dim=48)
            return out, lat

    out, lat = attend()
    assert out.shape == (2, 1, 8, 120) and out.dtype == torch.bfloat16
    assert lat.shape == (2, 40, 64) and lat.dtype == torch.bfloat16
    nsplit = DA.num_splits(2, 2, 4096)
    assert 1 < nsplit <= 4096 // DA.MIN_SPAN
    # the tensor-core entries take no dtype flag: bf16 only
    assert calls[0] == ("gqa tc", (2, 4096, 8, 2, 120, 4096, nsplit,
                                   pytest.approx(1.0 / np.sqrt(120))))
    assert calls[1] == ("mla tc", (2, 4096, 40, 64, 16, DA.num_splits(2, 1, 4096),
                                   pytest.approx(np.sqrt(48))))
    assert [fn.launches for fn in counters] == [
        launches[0], launches[1], launches[2] + 1, launches[3] + 1]
    out, lat = attend(torch.float32)
    assert calls[2] == ("gqa", (2, 4096, 8, 2, 120, 4096, nsplit,
                                pytest.approx(1.0 / np.sqrt(120)), 0))
    assert calls[3] == ("mla", (2, 4096, 40, 64, 16, DA.num_splits(2, 2, 4096),
                                pytest.approx(np.sqrt(48)), 0))
    assert [fn.launches for fn in counters] == [
        launches[0] + 1, launches[1] + 1, launches[2] + 1, launches[3] + 1]
    rc[0] = 719  # cudaErrorLaunchFailure
    with pytest.raises(RuntimeError, match="decode_attn_tc failed to launch"):
        attend()
    with pytest.raises(RuntimeError, match="decode_attn failed to launch"):
        attend(torch.float32)
    assert len(calls) == 6  # the refused tensor-core launch tried no other kernel

    def unbuildable():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "library", unbuildable)
    with pytest.raises(RuntimeError, match="nvcc"):
        attend()


@pytest.mark.parametrize("dk,dv", [(256, 256), (12, 12), (192, 136)])
def test_bf16_attention_widths_the_card_refuses_are_refused_everywhere(dk, dv):
    """bf16 head widths outside the tensor-core kernels' buckets (not a
    multiple of 8, Dk > 192 or Dv > 128) raise the same ValueError on the
    CPU, on meta tensors (the dry-run's) and on CUDA tensors (fake ones: no
    card here) before any launch; f32 takes those widths."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.flash_attn import kernel as FA

    def operands(device, dtype):
        return (torch.zeros(1, 8, 2, dk, dtype=dtype, device=device),
                torch.zeros(1, 8, 1, dk, dtype=dtype, device=device),
                torch.zeros(1, 8, 1, dv, dtype=dtype, device=device))

    launches = FA.flash_attn_fwd.launches
    for device in ("cpu", "meta"):
        with pytest.raises(ValueError, match="bf16 head dims"):
            FA.flash_attn_fwd(*operands(device, torch.bfloat16))
    with FakeTensorMode(), pytest.raises(ValueError, match="bf16 head dims"):
        FA.flash_attn_fwd(*operands("cuda", torch.bfloat16))
    assert FA.flash_attn_fwd.launches == launches
    o32, lse = FA.flash_attn_fwd(*operands("cpu", torch.float32))
    assert o32.shape == (1, 8, 2, dv) and bool(torch.isfinite(o32).all())
