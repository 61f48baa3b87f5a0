"""The traced run's records, reduced from torch.profiler's trace.

A TraceData holds the device's operations (kernels, copies and memsets,
from CUPTI) and the host's marked ranges (record_function: the harness's
"bench.compress" / "bench.decompress" around each call, and the program's
own stage marks), all in the trace's microseconds.  Metric readers ask it
for the time of kernels, or of any device activity, inside a set of host
intervals.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}


def _merge(iv: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _overlap(merged: list[tuple[float, float]], s: float, e: float) -> float:
    """Length of [s, e] covered by merged (sorted, disjoint) intervals."""
    i = max(bisect.bisect_right(merged, (s, float("inf"))) - 1, 0)
    total = 0.0
    while i < len(merged) and merged[i][0] < e:
        total += max(0.0, min(e, merged[i][1]) - max(s, merged[i][0]))
        i += 1
    return total


class TraceData:
    def __init__(self, events: list[dict]):
        self.device_ops = []        # (name, kind, start_us, end_us)
        self.spans = []             # (name, start_us, end_us)
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            s = float(ev["ts"])
            e = s + float(ev["dur"])
            cat = str(ev.get("cat", "")).lower()
            if cat in DEVICE_CATS:
                self.device_ops.append((ev.get("name", "?"), DEVICE_CATS[cat], s, e))
            elif cat == "user_annotation":
                self.spans.append((ev.get("name", "?"), s, e))
        self.device_ops.sort(key=lambda op: op[2])
        self.spans.sort(key=lambda sp: (sp[1], -sp[2]))   # outer first
        self._busy = _merge([(s, e) for _n, _k, s, e in self.device_ops])
        self._kstarts = [s for _n, k, s, _e in self.device_ops if k == "kernel"]
        self._kdur = [e - s for _n, k, s, e in self.device_ops if k == "kernel"]

    @classmethod
    def load(cls, path) -> "TraceData":
        with open(path) as f:
            return cls(json.load(f).get("traceEvents", []))

    def intervals(self, name: str) -> list[tuple[float, float]]:
        """The host ranges marked `name`, in order."""
        return [(s, e) for n, s, e in self.spans if n == name]

    def kernel_us(self, intervals) -> float:
        """Summed duration of the kernels that start inside the intervals."""
        total = 0.0
        for s, e in intervals:
            lo = bisect.bisect_left(self._kstarts, s)
            hi = bisect.bisect_left(self._kstarts, e)
            total += sum(self._kdur[lo:hi])
        return total

    def busy_us(self, intervals) -> float:
        """Time inside the intervals in which the device ran anything."""
        return sum(_overlap(self._busy, s, e) for s, e in intervals)

    def window(self) -> tuple[float, float] | None:
        calls = (self.intervals("bench.compress")
                 + self.intervals("bench.decompress"))
        if not calls:
            return None
        return min(s for s, _ in calls), max(e for _, e in calls)

    def top_device_ops(self, n: int = 10) -> list[list]:
        by_name: dict[str, float] = defaultdict(float)
        for name, _k, s, e in self.device_ops:
            by_name[name] += (e - s) / 1e6
        return [[k, v] for k, v in sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """Idle device time inside the window, summed by the innermost host
        range that was open at the time (a program stage before a call of
        the harness), in seconds."""
        win = self.window()
        if win is None:
            return []
        cuts = sorted({win[0], win[1]} | {x for _n, s, e in self.spans
                                          for x in (s, e) if win[0] < x < win[1]})
        starts = [s for _n, s, _e in self.spans]
        by_label: dict[str, float] = defaultdict(float)
        for a, b in zip(cuts, cuts[1:]):
            idle = (b - a) - _overlap(self._busy, a, b)
            if idle <= 0:
                continue
            mid, label = (a + b) / 2, "outside any marked range"
            # ranges nest, so the latest-started one that holds mid is the
            # innermost; a few steps back reach the call's own range
            hi = bisect.bisect_right(starts, mid)
            for name, _s, e in reversed(self.spans[max(hi - 64, 0):hi]):
                if e >= mid:
                    label = name
                    break
            by_label[label] += idle / 1e6
        return [[k, v] for k, v in sorted(by_label.items(),
                                          key=lambda kv: -kv[1])[:n]]
