"""Block-based whole-codec benchmark — the reference's `fse -b` mode
(programs/bench.c: 32KB default chunks `DEFAULT_CHUNKSIZE` bench.c:98,
timed loops, ratio + MB/s report, XXH32 round-trip check bench.c:312).

Three modes (bench_files' device):

* "host" times the bit-exact host twins (refimpl/), block by block;
* "cuda" times the batched compat codecs on CUDA
  (models.get_batch_codec at the chunk size: the FSE and Huff0 kernels
  of ops/), all blocks a call;
* "turbo" times the TurboRANS entry points on CUDA
  (turbo_compress_device / turbo_decompress_device; group-based, so the
  chunk size is the group size, at least 1 MiB).

The JAX module's docstring names a device mode of the compat codecs, but
its bench_files times the host twins under that flag; "cuda" runs the
device codecs.  zlibh has no port: -z runs the reference binary's own
bench mode when it is built.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

from ..utils.xxhash32 import xxh32

DEFAULT_CHUNKSIZE = 32 * 1024


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _bench_host(data: bytes, codec: str, iters: int, block_size: int):
    from ..refimpl import fse, huf

    comp = fse.fse_compress if codec == "fse" else huf.huf_compress
    blocks = [data[i : i + block_size] for i in range(0, len(data), block_size)]

    best_c = float("inf")
    csize = 0
    results = []
    for _ in range(iters):
        t0 = time.perf_counter()
        results = [comp(b) for b in blocks]
        best_c = min(best_c, time.perf_counter() - t0)
    csize = sum(len(r.data) if hasattr(r, "data") else len(r) for r in results)

    from ..refimpl.blocktypes import Kind

    best_d = float("inf")
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = []
        for blk, r in zip(blocks, results):
            if r.kind == Kind.COMPRESSED:
                dec = (fse.fse_decompress(r.data, len(blk)) if codec == "fse"
                       else huf.huf_decompress(r.data, len(blk)))
            elif r.kind == Kind.RLE:
                dec = bytes([r.data[0]]) * len(blk)
            else:
                dec = r.data
            out.append(dec)
        best_d = min(best_d, time.perf_counter() - t0)
    assert xxh32(b"".join(out)) == xxh32(data), "round-trip mismatch"
    return csize, best_c, best_d


def _bench_cuda(data: bytes, codec: str, iters: int, block_size: int):
    """The compat codec `codec` ("fse" or "huf") on CUDA: every block in
    one compress_blocks call, every block back in one decompress_blocks
    call; csize counts the block payloads, as _bench_host does."""
    from ..models import get_batch_codec
    from ..refimpl.blocktypes import Kind

    compress, decompress = get_batch_codec(codec, block_size=block_size)
    blocks = [data[i : i + block_size] for i in range(0, len(data), block_size)]

    best_c = float("inf")
    results = []
    for _ in range(iters):
        t0 = time.perf_counter()
        results = compress(blocks)
        best_c = min(best_c, time.perf_counter() - t0)
    csize = sum(len(r.data) for r in results)

    coded = [(r.data, len(b)) for b, r in zip(blocks, results)
             if r.kind == Kind.COMPRESSED]
    best_d = float("inf")
    dec = []
    for _ in range(iters):
        t0 = time.perf_counter()
        dec = decompress(coded)
        best_d = min(best_d, time.perf_counter() - t0)
    it = iter(dec)
    out = [next(it) if r.kind == Kind.COMPRESSED
           else bytes([r.data[0]]) * len(b) if r.kind == Kind.RLE else r.data
           for b, r in zip(blocks, results)]
    assert xxh32(b"".join(out)) == xxh32(data), "round-trip mismatch"
    return csize, best_c, best_d


def _bench_turbo(data: bytes, iters: int, group_size: int):
    from ..turbo.api import turbo_compress_device, turbo_decompress_device

    best_c = float("inf")
    blob = b""
    for _ in range(iters):
        t0 = time.perf_counter()
        blob = turbo_compress_device(data, group_size=group_size)
        best_c = min(best_c, time.perf_counter() - t0)
    best_d = float("inf")
    out = b""
    for _ in range(iters):
        t0 = time.perf_counter()
        out = turbo_decompress_device(blob)
        best_d = min(best_d, time.perf_counter() - t0)
    assert xxh32(out) == xxh32(data), "round-trip mismatch"
    return len(blob), best_c, best_d


def _bench_zlibh_via_reference(path: str, iters: int):
    """zlibh is a comparison baseline only (SURVEY #27): run the reference
    binary's own benchmark mode rather than porting zlib's Huffman."""
    import subprocess

    ref = Path(__file__).resolve().parents[2] / "tools/ref/bin/fse"
    if not ref.exists():
        log("zlibh: reference binary unavailable (run tools/ref/build.sh)")
        return 1
    out = subprocess.run([str(ref), "-b", "-z", f"-i{iters}", path],
                         capture_output=True, text=True)
    for line in (out.stdout + out.stderr).splitlines():
        if line.strip():
            log(f"zlibh(ref) {line.strip()}")
    return out.returncode


def bench_files(paths, codec="fse", iters=4, block_size=DEFAULT_CHUNKSIZE,
                device="host") -> int:
    """Bench each file and log one line per file; device is "host", "cuda"
    or "turbo" (see the module docstring).  The "cuda" and "turbo" modes
    raise when no CUDA device is present."""
    if device not in ("host", "cuda", "turbo"):
        raise ValueError(f"device must be host, cuda or turbo; got {device!r}")
    for path in [p for p in paths if p]:
        if codec == "zlibh":
            _bench_zlibh_via_reference(path, iters)
            continue
        data = Path(path).read_bytes()
        n = len(data)
        if device == "turbo":
            gsz = max(block_size, 1 << 20)
            csize, tc, td = _bench_turbo(data, iters, gsz)
            name = "turboRANS"
        elif device == "cuda":
            csize, tc, td = _bench_cuda(data, codec, iters, block_size)
            name = codec
        else:
            csize, tc, td = _bench_host(data, codec, iters, block_size)
            name = codec
        log(f"{Path(path).name:20s} {name:10s} ratio {n/max(csize,1):6.3f}  "
            f"comp {n/tc/1e6:9.1f} MB/s  decomp {n/td/1e6:9.1f} MB/s")
    return 0
