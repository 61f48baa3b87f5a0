"""Run one cell of the benchmark and print its result as the last line of
standard output (one JSON object), the numbers compared beside their
limits as the last lines of standard error.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The card is required: without CUDA, or with fewer cards than the cell
asks for, the run exits 2 and prints no result.  A run that finds JAX or
the JAX package loaded once the window has closed exits 3.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# caches the program's toolchains may keep, at fixed paths in the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "h100_bench" / sub)
sys.path.insert(0, str(ROOT))

from h100_bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.find_cell(args.workload)

    import torch

    chips = int(cell.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100_bench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"h100_bench: loaded in the measured process: {found}",
              file=sys.stderr)
        return 3
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
