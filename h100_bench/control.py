"""The check of the check, on the card: runs a cell on many seeds as it is
(the lower readings of the numbers compared) and with each fault of
faults.py planted under the timed path (the upper readings), all in one
process, and prints one JSON line a run and a summary line last.

    python3 h100_bench/control.py --workload <cell> --seconds <s> \
        --sound-seeds 1,2,3 --fault-seeds 4,5,6 [--faults control,...]

The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from h100_bench import harness  # noqa: E402
from h100_bench.faults import FAULTS  # noqa: E402

COMPARED = ("failed_calls", "output_mismatches", "reference_mismatches")


def _ints(text: str) -> list[int]:
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--sound-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--faults", default=",".join(FAULTS))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    runs = [(s, None) for s in args.sound_seeds] + [
        (s, f) for f in args.faults.split(",") for s in args.fault_seeds]
    readings: dict[str | None, dict[str, list]] = {}
    for seed, fault in runs:
        r = harness.run(args.workload, seed, args.seconds, False, fault=fault)
        checks = {k: c["value"] for k, c in r["checks"].items()}
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": fault,
                          "correct": r["correct"], "checks": checks,
                          "metrics": {k: m["value"] for k, m in r["metrics"].items()},
                          "kind": r["device"]["kind"],
                          "power_limit_w": r["device"]["power_limit_w"]}), flush=True)
        for k in COMPARED:
            readings.setdefault(fault, {}).setdefault(k, []).append(checks[k])
        gc.collect()
        torch.cuda.empty_cache()
    summary = {"workload": args.workload, "seconds": args.seconds,
               "lower": {k: max(v) for k, v in readings.get(None, {}).items()},
               "faults": {f: {k: min(v) for k, v in d.items()}
                          for f, d in readings.items() if f},
               "sound_all_correct": all(v == 0 for vs in readings.get(None, {}).values()
                                        for v in vs)}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
