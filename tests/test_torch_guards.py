"""Guards of the PyTorch port: it imports nothing of the JAX package, its
CLI runs on the CPU when asked, and nothing falls back to the CPU when the
card was asked for."""
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
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax", "optax")]
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
    cfg = get_config("olmo-1b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"w": np.zeros((2, 2), np.float32)})
    assert resolve("cpu").type == "cpu"
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert params["embed"].device.type == "cpu"


def test_unported_flags_raise():
    from repro_torch.launch import train

    for argv in (["--scenario", "paper-fig3"], ["--obs-health"],
                 ["--trace-viz", "x.json"], ["--codec", "bitmap"],
                 ["--payload-accounting", "measured"]):
        with pytest.raises(SystemExit, match="not ported"):
            train.run(train.parse_args(argv + ["--device", "cpu"]))


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
