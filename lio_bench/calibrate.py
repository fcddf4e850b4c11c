#!/usr/bin/env python3
"""Readings that the limits of `limits/<cell>.json` are set from; the
benchmark's own runs never run this.

    python3 lio_bench/calibrate.py --workload <cell> --seconds 20 \
        --seeds 1,2,... [--control-seeds 1,2,3] [--faults unchanged,half,altered] \
        [--fault-seeds 1,2,3] [--out chiprun_out/calib.jsonl]

One process, on the card.  For each seed, a whole run of the cell (set-up,
the measured window, the reference's replay) gives the numbers that sound
runs of the program read.  For each control seed, the reference replays the
same messages with TF32 products in the program's place (the control: the
precision one step below the configuration's float32), and the float32
reference follows it window by window as it follows the program.  For
each fault and fault seed, a run with that fault planted
under the program's step (faults.py) is compared with the reference.  One
JSON line per reading.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _ints(s: str):
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from lio_bench import compare
    from lio_bench.cells import build_config, resolve
    from lio_bench.drive import run_cell
    from lio_bench.faults import planted
    from lio_bench.reference.lio import config as ref_config
    from lio_bench.reference.replay import replay

    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = resolve(args.workload)
    out = open(args.out, "a") if args.out else None
    est = build_config(ref_config, cell.config, cell.mix).estimate_extrinsics

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    runs = [(s, None) for s in args.seeds]
    runs += [(s, f) for f in args.faults.split(",") if f for s in args.fault_seeds]
    for seed, fault in runs:
        t0 = time.perf_counter()
        if fault:
            with planted(fault):
                r = run_cell(cell, seed, args.seconds, False, t0, device=args.device)
        else:
            r = run_cell(cell, seed, args.seconds, False, t0, device=args.device)
        prog, ref = r["_outputs"]
        row = {"cell": cell.name, "seed": seed, "reading": fault or "program",
               "correct": r["correct"], "numbers": {k: v["value"] for k, v in r["checks"].items()},
               "metrics": {k: v["value"] for k, v in r["metrics"].items()},
               "run": r["_info"], "seconds": time.perf_counter() - t0}
        emit(row)
        if fault is None and seed in args.control_seeds:
            t1 = time.perf_counter()
            # the control in the program's place, followed by the float32 reference
            n = r["_info"]["messages"]
            ctrl, ctrl_windows = replay(cell, r["_stream"], n, args.device, "tf32")
            ref32, _ = replay(cell, r["_stream"], n, args.device, follow=ctrl_windows)
            nums = compare.gaps(ctrl, ref32, est)
            emit({"cell": cell.name, "seed": seed, "reading": "control_tf32", "numbers": nums,
                  "seconds": time.perf_counter() - t1})
            del ctrl, ctrl_windows, ref32
        del r, prog, ref
        if args.device == "cuda":
            torch.cuda.empty_cache()
    emit({"cell": cell.name, "done": True, "device": args.device,
          "process_s": time.perf_counter() - T0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
