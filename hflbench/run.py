"""The port's benchmark: one run of one cell, one result line.

    python3 hflbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with the CUDA device(s) the cell
asks for.  See ``hflbench/README.md``.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "hflbench_cache"


def bootstrap():
    """The process's start, shared with ``calibrate.py``: every cache at a
    fixed path inside the checkout (only the first run of a checkout builds
    and compiles), one intra-op thread (the program's host work is one
    Python thread, and idle workers only contend with it), and the package's
    own modules imported as ``hflbench.*``, never from the script's directory."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    os.environ["OMP_NUM_THREADS"] = "1"
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != here]


if __name__ == "__main__":
    bootstrap()
    from hflbench.harness import run

    sys.exit(run(sys.argv[1:], T_START))
