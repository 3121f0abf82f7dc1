"""Building and loading the hand-written CUDA kernels.

Every ``src/repro_torch/csrc/*.cu`` is compiled for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) by ``nvcc``, one object per
source with all compilers started together, then linked into ONE shared
library with a plain C interface, loaded through ``ctypes``. The build
happens at first use, into ``build/repro_torch_kernels/`` at the root of
the checkout, keyed by a hash of the sources and flags, so a fresh
checkout builds everything it needs from its own sources.

``-Xptxas -v`` reports each kernel's registers, spills and shared
memory; ``log_path()`` keeps that output beside the library.

Each C entry launches on the stream it is given (PyTorch's current
stream) and returns ``cudaGetLastError()``; ``check`` raises on nonzero.
Nothing here runs at import: the tests import every module on machines
without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# C entry -> argtypes (pointers and the stream as c_void_p)
SIGNATURES = {
    "rt_block_select": [P, LL, P, I, I, LL, P, P, P, P],
    "rt_update_max": [P, P, P, F, LL, P, P, P, P],
    "rt_tail_hist": [P, P, I, LL, I, P, P, P],
    "rt_apply_mask": [P, P, P, LL, P, P, P, P],
    "rt_bitpack": [P, LL, P, P, P],
    "rt_bitpack_active_clusters": [P],
    "rt_flash_attn_fwd": [P, P, P, P, P, I, I, I, I, I, I, I, LL, I, F, I, P],
    "rt_flash_attn_bwd": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, LL,
                          I, F, I, P],
    "rt_decode_attn": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, I, P],
    "rt_mla_decode_attn": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, I, P],
    "rt_decode_attn_tc": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, P],
    "rt_mla_decode_attn_tc": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, P],
    "rt_radix_select": [P, LL, LL, LL, P, P, P, P, P, P],
    "rt_sgdm": [P, P, P, LL, I, I, F, F, F, I, P],
}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found (looked at $NVCC, PATH and "
                       "/usr/local/cuda/bin/nvcc); the CUDA kernels cannot "
                       "be built on this machine")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"


def log_path() -> Path:
    """The compilers' output of the library's build (``-Xptxas -v``)."""
    return library_path().with_suffix(".log")


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; returns
    the library path. Objects compile in parallel, one ``nvcc`` each."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        errors, logs = [], []
        for src, proc in procs:
            log, _ = proc.communicate()
            logs.append(log)
            if proc.returncode:
                errors.append(f"nvcc failed on {src.name}:\n{log}")
        if errors:
            raise RuntimeError("\n".join(errors))
        log_path().write_text("".join(logs))  # ptxas: registers, spills, smem
        tmp_lib = Path(tmp) / out.name
        res = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp_lib, out)  # atomic: concurrent builders agree
    return out


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def timed_build() -> float:
    """Build (if needed) and load the library; returns the seconds taken."""
    t0 = time.perf_counter()
    library()
    return time.perf_counter() - t0


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError {rc}")


# observers of the hand-written kernels' work (``launch.op_cost``): each
# is called with the kernel's name, its operand and result bytes and the
# flops it reports
launch_observers: list = []


def report_cost(fn, *tensors, flops: float = 0.0) -> None:
    """Pass the bytes of ``tensors`` (a call's operands and results) and
    ``flops`` of wrapper ``fn``'s kernel to every observer. A wrapper
    given ``meta`` tensors reports what its kernel would do, launching
    nothing."""
    if launch_observers:
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        for observe in launch_observers:
            observe(fn.__name__, nbytes, float(flops))


def count_launch(fn, *tensors, flops: float = 0.0) -> None:
    """One launch of wrapper ``fn``'s kernel: add one to ``fn.launches``
    and report its cost (``report_cost``)."""
    fn.launches += 1
    report_cost(fn, *tensors, flops=flops)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)
