"""Non-IID extension (paper §VI future work): HFL under label-skewed data,
the port of ``examples/noniid_hfl.py``, on the card unless ``--device cpu``.

Compares IID vs label-sorted (the paper's "no shuffling" split) vs
Dirichlet(α=0.3) partitions of the same synthetic CIFAR-shaped images
with the faithful Algorithm-5 engine (``core.federated.FaithfulHFL``, the
paper's 7 clusters x 4 MUs and φ), measuring how the hierarchical
consensus and its error feedback cope with client drift. The example's
seeds (data 3, partitions 1, batches 2, test 9), so both packages draw
the same images, shards and batches.

    PYTHONPATH=src python -m repro_torch.launch.noniid_hfl \\
        --device cpu --width 0.125 --steps 2
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.core.federated import FaithfulHFL
from repro_torch.data import (
    SyntheticImages, partition_dirichlet, partition_iid, partition_label_sorted,
)
from repro_torch.device import resolve
from repro_torch.launch.paper_accuracy import build, paper_hfl

SPLITS = ("iid", "label-sorted (paper)", "dirichlet(0.3)")


def make_splits(labels, K: int) -> dict:
    """The example's three partitions of ``labels`` over K MUs."""
    return {
        "iid": partition_iid(len(labels), K, np.random.default_rng(1)),
        "label-sorted (paper)": partition_label_sorted(labels, K),
        "dirichlet(0.3)": partition_dirichlet(labels, K, alpha=0.3,
                                              rng=np.random.default_rng(1)),
    }


def _wait(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(steps: int = 100, *, period: int = 4, width: float = 0.25,
        batch_per_mu: int = 16, lr: float = 0.05, device=None,
        omega_impl: str = "topk", fns=None, on_step=None) -> dict:
    """Train each split ``steps`` faithful steps from the same init and
    evaluate the global model's top-1. ``fns`` = (w0, loss_fn, acc_fn)
    overrides the init (``paper_accuracy.make_fns``); ``on_step(split, t,
    sim, metrics)`` runs after each step, outside its timing. -> {split:
    {"losses", "acc", "step_s"}}."""
    dev = resolve(device)
    if dev.type == "cuda":  # f32 convolutions and matmuls, never TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    # oneDNN's CPU convolution backward races (paper_accuracy.run): the CPU
    # path takes ATen's own convolutions, the card cuDNN
    with torch.backends.mkldnn.flags(enabled=dev.type != "cpu"):
        w0, loss_fn, acc_fn = fns if fns is not None else build(width, device=dev)
        data = SyntheticImages(seed=3)
        xs, ys = data.sample(4096)
        xt, yt = data.sample(512, np.random.default_rng(9))
        xs_d, ys_d = torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)
        xt_d, yt_d = torch.from_numpy(xt).to(dev), torch.from_numpy(yt).to(dev)
        hfl = paper_hfl(7, 4, period)
        out = {}
        for name, shards in make_splits(ys, hfl.total_mus).items():
            sim = FaithfulHFL(loss_fn=loss_fn, w0=w0, hfl_cfg=hfl,
                              lr_schedule=lambda t: lr, sparsify_impl=omega_impl)
            rng = np.random.default_rng(2)
            losses, step_s = [], []
            for t in range(steps):
                idx = torch.from_numpy(np.stack([
                    rng.choice(s, batch_per_mu, replace=len(s) < batch_per_mu)
                    for s in shards])).to(dev)
                _wait(dev)
                ts = time.perf_counter()
                m = sim.step((xs_d[idx], ys_d[idx]))  # floats: waits for the step
                step_s.append(time.perf_counter() - ts)
                losses.append(m["loss"])
                if on_step is not None:
                    on_step(name, t, sim, m)
            acc = acc_fn(sim.global_model, xt_d, yt_d)
            print(f"  {name:24s} top-1 = {acc*100:5.1f}%", flush=True)
            out[name] = {"losses": losses, "acc": acc, "step_s": step_s}
        return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.noniid_hfl")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--period", type=int, default=4)
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--batch-per-mu", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--omega-impl", default="topk",
                    choices=["topk", "hist", "pallas", "fused"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    return run(args.steps, period=args.period, width=args.width,
               batch_per_mu=args.batch_per_mu, lr=args.lr, device=args.device,
               omega_impl=args.omega_impl)


if __name__ == "__main__":
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    main()
