"""Guards of the PyTorch port: it imports nothing of the JAX package, its
entry points (the training CLI, the paper-exact path) run on the CPU when
asked, and nothing falls back to the CPU when the card was asked for."""
import ast
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
                                  "ml_dtypes")]
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
    from repro_torch.launch import train

    for argv in (["--obs-health"], ["--trace-viz", "x.json"],
                 ["--metrics-out", "m.jsonl"], ["--ckpt-dir", "ckpt"]):
        with pytest.raises(SystemExit, match="not ported"):
            train.run(train.parse_args(argv + ["--device", "cpu"]))
    # a scenario the port does not run yet names its ROADMAP item
    with pytest.raises(NotImplementedError, match="not ported yet: ROADMAP"):
        train.run(train.parse_args(["--scenario", "hier-3tier", "--device", "cpu"]))


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
