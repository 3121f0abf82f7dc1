"""Codec benchmark: measured bits/param vs φ, encode throughput, crossover;
the port of ``benchmarks/comm_bits.py``, on the card unless ``--device cpu``.

Sparsifies one flat vector at each φ with the port's payload path
(``core.sparsify.pack_phi`` on the device) and measures every registered
codec on the resulting ``(values, indices)`` payloads:

  * bits/param per (codec, φ), byte-accurate stream lengths, with the two
    invariants asserted inline: ``dense-f32`` at φ=0 equals the analytic
    ``LatencyParams.payload(0.0)`` bit for bit, and at φ=0.99 at least one
    sparse codec beats the idealized ``32·(1-φ)`` bits/param;
  * encode throughput (payload entries/s of the host ``encode``);
  * the ``best`` meta-codec's winner per φ and the bitmap -> delta-stream
    crossover.

The vector is a numpy gaussian from ``seed`` unless ``x`` is given (the
reference draws it with ``jax.random``, whose bits the port cannot
reproduce; the tests pass the reference's own vector).

    PYTHONPATH=src python -m repro_torch.launch.comm_bits --device cpu --size 4096

writes ``build/comm_bits/BENCH_comm.json`` at the root of the checkout.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.comm.codecs import CODECS, get_codec
from repro_torch.core import sparsify as sp
from repro_torch.device import resolve
from repro_torch.wireless.latency import LatencyParams

PHIS = (0.0, 0.9, 0.99)
CROSSOVER_PHIS = (0.5, 0.75, 0.9, 0.95, 0.97, 0.99, 0.995, 0.999)
OUT = Path(__file__).resolve().parents[3] / "build" / "comm_bits" / "BENCH_comm.json"


def _payload(x, phi):
    """(values, indices) on the host: the dense vector at φ <= 0, else
    ``pack_phi`` run where x lies."""
    if phi <= 0.0:
        flat = x.reshape(-1).cpu().numpy()
        return flat, np.arange(flat.size, dtype=np.int32)
    vals, idx = sp.pack_phi(x, phi)
    return vals.cpu().numpy(), idx.cpu().numpy()


def run(size: int = 1 << 18, seed: int = 0, throughput_phi: float = 0.99, *,
        x=None, device=None):
    """-> (rows for the CSV harness, artifact dict)."""
    dev = resolve(device)
    if x is None:
        x = np.random.default_rng(seed).standard_normal(size).astype(np.float32)
    x = torch.from_numpy(np.array(x, np.float32).reshape(-1)).to(dev)
    size = x.numel()
    lp = LatencyParams(model_params=float(size))

    per_codec = {name: {} for name in CODECS}
    for phi in PHIS:
        vals, idx = _payload(x, phi)
        for name, codec in CODECS.items():
            per_codec[name][str(phi)] = codec.measure_bits(vals, idx, size) / size

    assert per_codec["dense-f32"]["0.0"] * size == lp.payload(0.0), \
        "dense-f32 must equal the analytic payload at phi=0 bit-for-bit"
    analytic_99 = 32.0 * (1.0 - 0.99)
    sparse_wins = [n for n, r in per_codec.items()
                   if n != "best" and not n.startswith("dense")
                   and r["0.99"] < analytic_99]
    assert sparse_wins, "no sparse codec beats 32*(1-phi) bits/param at 0.99"

    # encode throughput on the φ=0.99 payload (host path; entries/s)
    vals, idx = _payload(x, throughput_phi)
    throughput = {}
    for name, codec in CODECS.items():
        t0 = time.perf_counter()
        reps = 0
        while time.perf_counter() - t0 < 0.2:
            codec.encode(vals, idx, size)
            reps += 1
        throughput[name] = vals.size / ((time.perf_counter() - t0) / reps)

    # crossover: the best meta-codec's winner along a φ sweep
    best = get_codec("best")
    winners = {}
    for phi in CROSSOVER_PHIS:
        v, i = _payload(x, phi)
        codec, bits = best.choose(v, i, size)
        winners[str(phi)] = {"codec": codec.name, "bits_per_param": bits / size}
    crossover, prev = None, None
    for phi in CROSSOVER_PHIS:
        w = winners[str(phi)]["codec"]
        if prev is not None and prev.startswith("bitmap") and w.startswith("delta"):
            crossover = phi
        prev = w

    artifact = {
        "size": size,
        "device": str(dev),
        "phis": list(PHIS),
        "bits_per_param": per_codec,
        "analytic_bits_per_param": {str(p): 32.0 * (1.0 - p) for p in PHIS},
        "dense_f32_matches_analytic_phi0": True,  # asserted above
        "sparse_codecs_beating_analytic_at_0.99": sparse_wins,
        "encode_entries_per_s": throughput,
        "best_winner_by_phi": winners,
        "bitmap_to_delta_crossover_phi": crossover,
    }
    rows = [
        (f"comm/{name}",
         ",".join(f"phi{p}={per_codec[name][str(p)]:.4g}b/param" for p in PHIS)
         + f",enc={throughput[name]:.3g}entries/s")
        for name in CODECS
    ]
    rows.append(("comm/crossover",
                 f"bitmap->delta@phi={crossover},"
                 f"winner@0.99={winners['0.99']['codec']}"))
    return rows, artifact


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.comm_bits")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--size", type=int, default=1 << 18)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rows, artifact = run(args.size, args.seed, device=args.device)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(artifact, f, indent=1, default=float)
    for tag, metrics in rows:
        print(f"{tag},{metrics}")
    print(f"# artifact -> {OUT}")


if __name__ == "__main__":
    main()
