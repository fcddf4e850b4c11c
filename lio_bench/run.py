#!/usr/bin/env python3
"""Benchmark of limovelo_tpu_torch on one NVIDIA card.

    python3 lio_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is a workload of BENCHMARK.json; its
configuration, traffic mix and limits are files under lio_bench/ (cells.py).
One run: render the stream from the seed, set up and warm up the program,
drive it for `--seconds`, replay the same messages through the plain
reference, compare.  The last line of standard output is one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics,
or with `--trace 1` its per-layer metrics), `device`, with `--trace 1`
`breakdown`, and last `checks`, each compared number beside its limit (also
the last lines of standard error).  An earlier line of standard output says
what the run drove (windows, windows that did not update, collapsed
windows, ATE against the course).

It exits non-zero and prints no result without a CUDA card, with fewer
cards than the cell asks for, without the program beside it, or when a JAX
module or the JAX package is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _fail(msg: str) -> int:
    print(f"lio_bench: {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # one compute thread on the host: the card does the arithmetic, and a
    # pool of threads on a shared host only adds to the spread of the timings
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    # build caches at fixed paths inside the checkout (the program's own
    # build/kernels and build/native are there already)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / sub)
    if not (ROOT / "limovelo_tpu_torch" / "__init__.py").is_file():
        return _fail(f"the program limovelo_tpu_torch is not in {ROOT}")
    sys.path.insert(0, str(ROOT))

    import torch

    torch.set_num_threads(1)

    from lio_bench.cells import resolve
    from lio_bench.drive import forbidden_modules, run_cell

    cell = resolve(args.workload)
    if not torch.cuda.is_available():
        return _fail("no CUDA device: the benchmark measures the program on an NVIDIA card")
    if torch.cuda.device_count() < cell.chips:
        return _fail(f"{args.workload} needs {cell.chips} cards, "
                     f"{torch.cuda.device_count()} present")
    torch.cuda.set_device(0)

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), T0, device="cuda")
    bad = forbidden_modules()
    if bad:
        return _fail(f"modules of JAX or the JAX package are loaded: {', '.join(bad)}")
    info = result.pop("_info")
    result.pop("_outputs")
    result.pop("_stream")
    print(json.dumps({"run": info}), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
