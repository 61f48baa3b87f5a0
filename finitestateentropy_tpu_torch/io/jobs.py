"""Resumable batch-compression jobs + metrics (SURVEY §5 aux subsystems).

The reference has no runtime-level checkpointing — compression is stateless
per block, so "the frame format is the checkpoint".  This layer makes that
explicit for long multi-group jobs: groups are written incrementally and a
sidecar manifest records the completed (input offset, output offset) ranges,
so an interrupted job resumes at the last complete group.  Idempotent per
group: re-running a completed range produces identical bytes (the codecs are
deterministic), which is the per-host retry story for distributed runs.

Failure detection mirrors the reference's layering: per-group decoder error
flags (rANS final-state + cursor residues) during the job, and a whole-file
XXH32 recorded in the manifest, checked on `verify`.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

from ..utils.xxhash32 import xxh32

MANIFEST_SUFFIX = ".manifest.json"


@dataclasses.dataclass
class JobMetrics:
    """Structured counters, the DISPLAYLEVEL analogue (fileio.c:162-172)."""

    groups_done: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    seconds: float = 0.0

    def as_dict(self):
        d = dataclasses.asdict(self)
        if self.seconds > 0:
            d["mb_per_s"] = round(self.bytes_in / self.seconds / 1e6, 1)
        if self.bytes_out:
            d["ratio"] = round(self.bytes_in / self.bytes_out, 3)
        return d


def _default_compress_group(chunk: bytes) -> bytes:
    from .. import native

    if native.available():
        # empty source files reach here with len(chunk) == 0; the native
        # entry rejects group == 0, so clamp (one group is always enough)
        return native.rans_compress_native(chunk, group_size=max(len(chunk), 1))
    from ..turbo.rans import rans_compress

    return rans_compress(chunk)


def compress_file_resumable(src_path, dst_path, group_size: int = 1 << 20,
                            compress_group=None, max_groups: int | None = None,
                            log=None) -> JobMetrics:
    """Compress src into a TurboRANS group stream, resumably.

    `max_groups` bounds work per call (used by tests to simulate preemption);
    call again to continue.  Returns metrics for this call.
    """
    src_path, dst_path = Path(src_path), Path(dst_path)
    manifest_path = Path(str(dst_path) + MANIFEST_SUFFIX)
    compress_group = compress_group or _default_compress_group

    src_size = src_path.stat().st_size
    n_groups = max(1, (src_size + group_size - 1) // group_size)

    if manifest_path.exists():
        m = json.loads(manifest_path.read_text())
        if m["group_size"] != group_size or m["src_size"] != src_size:
            raise ValueError("manifest does not match source/job parameters")
    else:
        m = {"group_size": group_size, "src_size": src_size,
             "n_groups": n_groups, "next_group": 0, "out_bytes": 0,
             "done": False}
        manifest_path.write_text(json.dumps(m))
        dst_path.write_bytes(b"")

    metrics = JobMetrics()
    t0 = time.perf_counter()
    with open(src_path, "rb") as fin, open(dst_path, "r+b") as fout:
        fout.truncate(m["out_bytes"])  # drop any partial tail group
        fout.seek(m["out_bytes"])
        g = m["next_group"]
        while g < m["n_groups"]:
            if max_groups is not None and metrics.groups_done >= max_groups:
                break
            fin.seek(g * group_size)
            chunk = fin.read(group_size)
            blob = compress_group(chunk)
            fout.write(blob)
            fout.flush()
            g += 1
            m["next_group"] = g
            m["out_bytes"] += len(blob)
            manifest_path.write_text(json.dumps(m))
            metrics.groups_done += 1
            metrics.bytes_in += len(chunk)
            metrics.bytes_out += len(blob)
            if log:
                log(f"group {g}/{m['n_groups']} done "
                    f"({m['out_bytes']} bytes out)")
        if g == m["n_groups"]:
            m["done"] = True
            m["xxh32"] = xxh32(src_path.read_bytes())
            manifest_path.write_text(json.dumps(m))
    metrics.seconds = time.perf_counter() - t0
    return metrics


def job_status(dst_path) -> dict | None:
    p = Path(str(dst_path) + MANIFEST_SUFFIX)
    return json.loads(p.read_text()) if p.exists() else None


def verify_job(dst_path, decompress=None) -> bool:
    """Decode the finished stream and check the manifest's XXH32.  The
    default decoder is the native codec, else turbo_decompress_device,
    which runs on CUDA and raises without it."""
    m = job_status(dst_path)
    if not m or not m.get("done"):
        return False
    if decompress is None:
        from .. import native

        if native.available():
            decompress = native.rans_decompress_native
        else:
            from ..turbo.api import turbo_decompress_device

            decompress = turbo_decompress_device
    out = decompress(Path(dst_path).read_bytes())
    return xxh32(out) == m["xxh32"]
