"""Paper Table III / Fig. 6 (scaled down): FL vs HFL accuracy parity, the
port of ``examples/paper_accuracy.py``, on the card unless ``--device cpu``.

Runs the FAITHFUL Algorithm-5 simulator (``core.federated.FaithfulHFL``:
per-MU DGC buffers, all four sparse hops) with a width-reduced ResNet-18
on synthetic CIFAR-shaped data, comparing
    * Baseline   (single worker, dense)
    * sparse FL  (28 MUs -> MBS, Alg. 4)
    * sparse HFL (7 clusters x 4 MUs, H in {2,4,6}, Alg. 5)
with the example's seeds (data 3, partition 1, batches 2, test 9), so both
packages draw the same images. The paper's claim: HFL matches or beats
sparse FL and stays close to the baseline.

    PYTHONPATH=src python -m repro_torch.launch.paper_accuracy \\
        --device cpu --width 0.125 --steps 2 --omega-impl pallas

``--omega-impl`` sets ``FaithfulHFL.sparsify_impl``: ``pallas`` runs every
hop through the DGC kernels (``update_max``, ``tail_hist``,
``apply_mask``), ``fused`` through ``block_select``.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs.base import HFLConfig, TierConfig
from repro_torch.core.federated import FaithfulHFL
from repro_torch.data import SyntheticImages, partition_iid
from repro_torch.device import resolve
from repro_torch.models.resnet import init_resnet18, resnet18_forward
from repro_torch.utils.tree import flatten_to_vector, unflatten_from_vector

PAPER_PHIS = (0.99, 0.9, 0.9, 0.9)  # φ_MU^ul, φ_SBS^dl, φ_SBS^ul, φ_MBS^dl


def paper_hfl(clusters: int, mus: int, period: int, phis=PAPER_PHIS,
              beta_s: float = 0.5, beta_m: float = 0.2) -> HFLConfig:
    """The reference example's legacy-keyword ``HFLConfig`` as tiers."""
    return HFLConfig(tiers=(
        TierConfig(fanout=mus, period=1, phi_up=phis[0], phi_down=phis[1]),
        TierConfig(fanout=clusters, period=period, phi_up=phis[2],
                   phi_down=phis[3], beta_up=beta_s, beta_down=beta_m)))


def make_fns(params, bn_state):
    """(w0, loss(w, (x, y)), acc_fn(w, x, y)) over the flat f32 vector of
    ``params``. Both run BatchNorm on batch statistics (``train=True``) and
    discard the new running stats, as the reference example does."""
    w0, aux = flatten_to_vector(params)

    def loss(w, batch):
        p = unflatten_from_vector(w, aux)
        x, y = batch
        logits, _ = resnet18_forward(p, bn_state, x, train=True)
        lp = torch.log_softmax(logits, dim=-1)
        return -lp.gather(1, y.long()[:, None]).mean()

    @torch.no_grad()
    def acc_fn(w, x, y):
        p = unflatten_from_vector(w, aux)
        logits, _ = resnet18_forward(p, bn_state, x, train=True)
        return float((logits.argmax(-1) == y).float().mean())

    return w0, loss, acc_fn


def build(width=0.25, seed=0, device=None):
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return make_fns(*init_resnet18(gen, width=width, device=dev))


def _wait(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(name, hfl_cfg, steps, batch_per_mu=16, lr=0.05, seed=0, *,
        width=0.25, device=None, omega_impl="topk", on_step=None) -> dict:
    """Train ``steps`` faithful steps and evaluate top-1 of the global model.
    ``on_step(t, sim, metrics)`` runs after each step, outside its timing.
    Returns the per-step losses and seconds, the accuracy and the
    first-step and steady seconds."""
    dev = resolve(device)
    if dev.type == "cuda":  # f32 convolutions and matmuls, never TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    # On the CPU, oneDNN's convolution backward (v3.12, 4+ threads) races:
    # gradients vary run to run and the heap gets corrupted. The CPU path
    # takes ATen's own convolutions instead; the card runs cuDNN.
    with torch.backends.mkldnn.flags(enabled=dev.type != "cpu"):
        w0, loss_fn, acc_fn = build(width=width, seed=seed, device=dev)
        data = SyntheticImages(seed=3)
        xs, ys = data.sample(4096)
        K = hfl_cfg.total_mus
        shards = partition_iid(len(xs), K, np.random.default_rng(1))
        sim = FaithfulHFL(loss_fn=loss_fn, w0=w0, hfl_cfg=hfl_cfg,
                          lr_schedule=lambda t: lr, sparsify_impl=omega_impl)
        xs_d, ys_d = torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)
        rng = np.random.default_rng(2)
        losses, step_s = [], []
        t0 = time.perf_counter()
        for t in range(steps):
            idx = torch.from_numpy(np.stack([rng.choice(s, batch_per_mu)
                                             for s in shards])).to(dev)
            _wait(dev)
            ts = time.perf_counter()
            m = sim.step((xs_d[idx], ys_d[idx]))  # floats: waits for the step
            step_s.append(time.perf_counter() - ts)
            losses.append(m["loss"])  # real mean training loss across MUs
            if on_step is not None:
                on_step(t, sim, m)
        xt, yt = data.sample(512, np.random.default_rng(9))
        acc = acc_fn(sim.global_model, torch.from_numpy(xt).to(dev),
                     torch.from_numpy(yt).to(dev))
        seconds = time.perf_counter() - t0
        final_loss = losses[-1] if losses else float("nan")
        print(f"  {name:24s} top-1 = {acc*100:5.1f}%  final-loss = {final_loss:.3f}"
              f"   ({seconds:.0f}s)", flush=True)
        return {"losses": losses, "acc": acc, "step_s": step_s,
                "first_step_s": step_s[0] if step_s else None,
                "steady_s_per_step": (float(np.mean(step_s[1:]))
                                      if len(step_s) > 1 else None),
                "seconds": seconds}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.paper_accuracy")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--batch-per-mu", type=int, default=16)
    ap.add_argument("--omega-impl", default="topk",
                    choices=["topk", "hist", "pallas", "fused"])
    args = ap.parse_args(argv)
    kw = dict(batch_per_mu=args.batch_per_mu, width=args.width,
              device=args.device, omega_impl=args.omega_impl)
    print(f"Table III (scaled): synthetic CIFAR-shaped data, ResNet18 "
          f"width {args.width}, omega={args.omega_impl}, device={args.device}")
    run("Baseline (1 MU, dense)", paper_hfl(1, 1, 1, phis=(0, 0, 0, 0)),
        args.steps, **kw)
    fl = run("sparse FL (28 MUs)", paper_hfl(1, 28, 1), args.steps, **kw)["acc"]
    accs = {H: run(f"sparse HFL 7x4, H={H}", paper_hfl(7, 4, H), args.steps,
                   **kw)["acc"] for H in (2, 4, 6)}
    best_hfl = max(accs.values())
    print(f"\npaper claim check: HFL ({best_hfl*100:.1f}%) >= FL ({fl*100:.1f}%) - "
          f"{'REPRODUCED' if best_hfl >= fl - 0.02 else 'NOT reproduced'}")


if __name__ == "__main__":
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    main()
