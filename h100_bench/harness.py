"""The benchmark's run of one cell: inputs from the seed, a warm-up, the
timed window, the check of what the window produced, and the metrics.

Everything that belongs to one cell is found by name under this folder:
workloads/<cell>.json names its configuration and traffic mix;
configs/<config>.json the system under test (systems/<system>.py), the
reference that judges its frames (reference/<reference>.py), the bytes a
call moves at least (work/<work>.py) and the entry points' flags;
traffic/<traffic>.json the generator (traffic/<generator>.py), the loop
(loops/<loop>.py) and their parameters.  Each metric of BENCHMARK.json is
read by metrics/<metric>.py.  A new cell, configuration or metric is a new
file; no existing file changes.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "finitestateentropy_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of this folder by file path (names may hold dots)."""
    name = "h100_bench_" + "_".join(path.relative_to(path.parents[1]).with_suffix("").parts)
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell(NamedTuple):
    name: str
    spec: dict          # workloads/<name>.json
    config: dict        # configs/<config>.json
    traffic: dict       # traffic/<traffic>.json
    root: Path


def cell_names(root: Path = BENCH) -> list[str]:
    return sorted(p.stem for p in (root / "workloads").glob("*.json"))


def find_cell(name: str, root: Path = BENCH) -> Cell:
    path = root / "workloads" / f"{name}.json"
    if not path.exists():
        raise SystemExit(f"unknown workload {name!r}; known: {cell_names(root)}")
    spec = load_json(path)
    return Cell(name, spec, load_json(root / "configs" / f"{spec['config']}.json"),
                load_json(root / "traffic" / f"{spec['traffic']}.json"), root)


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: the end-to-end ones untraced,
    the per-layer ones traced; an entry with "workloads" only in those."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: the port's name starts with the latter)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Record(NamedTuple):
    """What a metric reader reads."""
    calls: list                 # loops.Call of the window, in order
    sizes: list                 # bytes of each pool buffer
    setup_s: float
    trace: object               # trace.TraceData of a traced run, else None
    stages: dict | None         # the program's stage seconds (traced run)
    peak_bytes_per_s: float | None
    work: object                # work/<work>.py


def _power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def judge(cell: Cell, system, window, pool: list, inputs: list,
          device: str) -> dict:
    """The numbers compared, each beside its limit.  Every call that
    raised counts; every kept output is held against its input; every
    frame of the window is decoded by the reference (each distinct frame
    once) and held against its input."""
    failed = sum(not c.ok for c in window.calls)
    out_bad = sum(not system.same(out, inputs[b]) for b, out in window.outputs)
    n_out = len(window.outputs)
    window.outputs.clear()                 # the program's outputs are freed
    counts: dict[tuple[int, bytes], int] = {}
    for key in window.frames:
        counts[key] = counts.get(key, 0) + 1
    reference = load_module(cell.root / "reference" / f"{cell.config['reference']}.py")
    decoded = reference.decode_frames([f for _b, f in counts], device)
    ref_bad = sum(n for ((b, _f), n), d in zip(counts.items(), decoded)
                  if d is None or d != pool[b].tobytes())
    return {"failed_calls": {"value": failed, "limit": 0, "rule": "<="},
            "output_mismatches": {"value": out_bad, "limit": 0, "rule": "<="},
            "reference_mismatches": {"value": ref_bad, "limit": 0, "rule": "<="},
            "outputs_checked": {"value": n_out, "limit": 1, "rule": ">="},
            "frames_checked": {"value": len(window.frames), "limit": 1, "rule": ">="}}


def passes(check: dict) -> bool:
    v, lim = check["value"], check["limit"]
    return v <= lim if check["rule"] == "<=" else v >= lim


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", root: Path = BENCH, bench: dict | None = None,
        fault: str | None = None, t_start: float | None = None,
        trace_dir: Path | None = None) -> dict:
    """One run of a cell; returns the result line's object ("checks" last).
    device "cuda" is the card; the tests drive the rest of a run with
    device "cpu", where the program runs the plain versions of its
    kernels.  fault plants one of faults.FAULTS under the window."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    cell = find_cell(cell_name, root)
    bench = bench if bench is not None else load_json(root.parent / "BENCHMARK.json")
    seed = int(seed) % (1 << 64)
    system = load_module(root / "systems" / f"{cell.config['system']}.py").System(
        cell.config, device)
    pool = load_module(root / "traffic" / f"{cell.traffic['generator']}.py").make_pool(
        cell.traffic, seed)
    inputs = [system.load(b) for b in pool]
    sizes = [len(b) for b in pool]
    loop = load_module(root / "loops" / f"{cell.traffic['loop']}.py")
    loop.warm_up(system, inputs)
    if fault:                       # under the timed path only
        from h100_bench.faults import Broken
        system = Broken(system, fault)
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda:
        torch.cuda.synchronize()
    every = int(cell.config["keep_output_every"])
    offset = int(np.random.default_rng([seed, 1]).integers(every))

    def keep(i: int) -> bool:
        return (i - offset) % every == 0

    stages = trace_data = prof = span = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        system.trace_begin()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
        span = record_function
    window = loop.run(system, inputs, sizes, seconds, keep, span)
    if trace:
        prof.__exit__(None, None, None)
        stages = system.trace_end()
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    kind = torch.cuda.get_device_name(0) if on_cuda else "cpu"
    if trace:
        from h100_bench.trace import TraceData
        trace_dir = trace_dir or ROOT / "build" / "h100_bench"
        trace_dir.mkdir(parents=True, exist_ok=True)
        path = trace_dir / f"trace-{cell_name}.json"
        prof.export_chrome_trace(str(path))
        prof = None
        trace_data = TraceData.load(path)

    checks = judge(cell, system, window, pool, inputs, device)
    peaks = load_json(root / "peaks.json")["devices"].get(kind, {})
    rec = Record(window.calls, sizes, window.start - t_start, trace_data, stages,
                 peaks.get("hbm_bytes_per_s"),
                 load_module(root / "work" / f"{cell.config['work']}.py"))
    metrics = {}
    for m in metrics_for(bench, cell_name, trace):
        value = load_module(root / "metrics" / f"{m['name']}.py").read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_cuda else "cpu", "kind": kind,
           "count": int(cell.spec["chips"]), "memory_peak_bytes": int(peak),
           "power_limit_w": _power_limit_w() if on_cuda else None}
    result = {"correct": all(passes(c) for c in checks.values()),
              "attempted": len(window.calls),
              "failed": sum(checks[k]["value"] for k in
                            ("failed_calls", "output_mismatches", "reference_mismatches")),
              "metrics": metrics, "device": dev}
    if trace_data is not None:
        win = trace_data.window() or (0.0, 0.0)
        dev["busy_s"] = trace_data.busy_us([win]) / 1e6
        dev["window_s"] = (win[1] - win[0]) / 1e6
        result["breakdown"] = {"device_ops": trace_data.top_device_ops(),
                               "idle_gaps": trace_data.idle_gaps()}
    result["checks"] = checks
    return result


def check_lines(result: dict) -> list[str]:
    return [f"check {k} {c['value']} {'at most' if c['rule'] == '<=' else 'at least'} "
            f"{c['limit']}" for k, c in result["checks"].items()]
