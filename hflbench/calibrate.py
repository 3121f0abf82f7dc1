"""The readings a cell's limits are set from, on the chip at the cell's size.

    python3 hflbench/calibrate.py --workload NAME --seeds 1 2 3 ... [--controls 3]

For every seed the program is driven through set-up (the same first steps
a run reads) and the reference follows them: the gaps are the sound runs'
readings, whose largest is a number's lower reading.  For the first
``--controls`` seeds the control (the reference one precision down: float8
products for a bfloat16 configuration, TF32 for a float32 one) and the
program with each fault the check must catch planted in its timed path, as
the tests plant them, are held against the same reference.  One JSON line a
seed.
"""
import time

import run  # the command's own start, beside this file

run.bootstrap()

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from hflbench import check, harness  # noqa: E402

FAULTS = ("unchanged", "half_batch", "no_exchange", "altered")


def program(name, seed, device, tiny, fault=None):
    """The cell's driver after set-up (the first steps read), its state freed."""
    ctx = harness.context(name, seed, device, tiny, fault)
    drv = harness.load_module("drivers", ctx.cell["driver"]).Driver(
        ctx, harness.device_sync(device))
    drv.setup()
    drv.release()
    harness.free_device_memory(device)
    return drv


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    device = torch.device("cpu") if args.tiny else torch.device("cuda", 0)
    sync = harness.device_sync(device)
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        drv = program(args.workload, seed, device, args.tiny)
        sync()
        t1 = time.perf_counter()
        ref = drv.reference()
        sync()
        readings = lambda r: {**check.gaps(r, ref, drv.loss_steps),
                               "loss_by_step": check.loss_gaps(r, ref)}
        out = {"seed": seed, "setup_s": t1 - t0, "reference_s": time.perf_counter() - t1,
               "program": readings(drv.prog)}
        if i < args.controls:
            out["control"] = readings(drv.reference(lower=True))
            for fault in FAULTS:
                out[fault] = readings(program(args.workload, seed, device, args.tiny, fault).prog)
        print(json.dumps({"workload": args.workload, **out}), flush=True)
        del drv, ref
        harness.free_device_memory(device)


if __name__ == "__main__":
    main()
