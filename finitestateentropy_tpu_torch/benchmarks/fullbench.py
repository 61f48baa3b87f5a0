"""Per-stage micro-benchmarks — the reference's `fullbench` binary
(programs/fullbench.c:758-1237), same stage numbering:

  1  HIST_count(255)          20 HUF_compress             40 HUF_decompress4X1
  2  HIST_count(254)          21 HUF_buildCTable          41 HUF_readDTableX1
  3  HIST_countFast(254)      22 HUF_writeCTable          42 HUF_decompress4X1_usingDTable
  4  FSE_normalizeCount       23 HUF_compress4x_usingCT   45 HUF_decompress1X1
  5  FSE_writeNCount          25 HUF_readCTable           46 HUF_decompress1X1_usingDTable
  6  FSE_buildCTable          30 HUF_decompress           50 HUF_decompress4X2
  7  FSE_compress_usingCT     31 HUF_readStats            51 HUF_readDTableX2
  8  ..._smallDst             32 HUF_readDTable           52 HUF_decompress4X2_usingDTable
  9  FSE_compress             33 HUF_decompress_usingDT   55 HUF_decompress1X2
  11 FSE_readNCount                                       56 HUF_decompress1X2_usingDTable
  12 FSE_buildDTable          70 FSE_buildCTable_raw(6)
  13 FSE_decompress_usingDT   80 FSE_buildDTable(10)
  14 FSE_decompress           81 FSE_buildDTable(9)
                              82 FSE_buildDTable_raw(6)

bmi2 variants (24/43/47/53/57) and the experimental C histogram strategies
(100-107) are CPU-ISA experiments; the JAX package does not port them
either.

The port's own stages, the CUDA kernels behind the wrappers of
turbo/rans_kernels.py and the compat codecs of models/ (16 groups of 1 MiB;
64 blocks of 32 KiB):

  200 turbo-rans encode kernel (flat placement)   202 rans table pack (host)
  201 turbo-rans decode kernel (v1)               203 group prep (host)
  204 turbo-rans decode kernel (v2, rows wire)    205 encode kernel (v1)
  206 windowed-entry decode (byte, S=64)          207 encode (row-local)
  208 pair decode (windowed entry)                209 quad decode (windowed)
  215 quad encode (row-local)
  210 device fse_encode_batch                     212 device huf_encode_4x_batch
  211 device fse_decode_batch                     213 device huf_decode_4x1_batch
                                                  214 device huf_decode_4x2_batch

The device stages run on CUDA; `--device cpu` runs them on the CPU, where
the wrappers run the plain PyTorch versions of the kernels.  Without a
CUDA device a request for a stage >= 200 exits 1 unless --device cpu asks
for the CPU.

Usage: python -m finitestateentropy_tpu_torch.benchmarks.fullbench
           [--device cuda|cpu] [stage ...]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..utils import generate_proba

P_DEFAULT = 20  # reference fullbench generates 20% proba data (BMK_genData)


def _calibrated(fn, payload_bytes, min_time=0.25):
    fn()  # warm
    n, t = 0, 0.0
    t0 = time.perf_counter()
    while t < min_time:
        fn()
        n += 1
        t = time.perf_counter() - t0
    return payload_bytes * n / t


def _sync(out) -> None:
    """Wait for the kernels that wrote out (a tensor, or a tuple of them
    and None): a CUDA device sync; nothing on the CPU."""
    for t in out if isinstance(out, (tuple, list)) else (out,):
        if isinstance(t, torch.Tensor):
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
            return


def _calibrated_device(dispatch, payload_bytes, k1=2, k2=10, reps=3):
    """Queue-k timing for device kernel stages: k calls queued back to back,
    one sync after the last, for k = k1 and k2 (best of reps each); the
    rate is (k2 - k1) payloads over the difference of the two times.  A
    CUDA launch returns before its kernel ends, so the k kernels run back
    to back as the entry points run them, and the difference cancels what
    every timing pays once: the first launch's start and the final sync's
    round trip.  The wrapper's host work per call stays in, as it does on
    the main path."""
    _sync(dispatch())  # warm (and build the kernel)
    ts = {}
    for k in (k1, k2):
        best = 1e9
        for _ in range(reps):
            t0 = time.perf_counter()
            last = None
            for _ in range(k):
                last = dispatch()
            _sync(last)
            best = min(best, time.perf_counter() - t0)
        ts[k] = best
    dt = ts[k2] - ts[k1]
    return (k2 - k1) * payload_bytes / dt if dt > 0 else 0.0


def _stages():
    from ..errors import FSEError
    from ..refimpl import fse, huf
    from ..refimpl.hist import hist_count
    from ..refimpl.ncount import fse_read_ncount, fse_write_ncount
    from ..refimpl.norm import fse_normalize_count, fse_optimal_table_log
    from ..refimpl.tables import (build_ctable, build_ctable_raw,
                                  build_dtable, build_dtable_raw)

    data = generate_proba(P_DEFAULT)[:65536]
    src = np.frombuffer(data, np.uint8)
    n = len(src)
    count, max_sv, _ = hist_count(src, 255)
    tlog = fse_optimal_table_log(11, n, max_sv)
    norm, tlog = fse_normalize_count(tlog, count[: max_sv + 1], n, max_sv)
    nc = fse_write_ncount(norm, max_sv, tlog)
    ct = build_ctable(norm, max_sv, tlog)
    dt = build_dtable(norm, max_sv, tlog)
    payload = fse.fse_compress_using_ctable(data, ct)
    hct = huf.huf_build_ctable(count, max_sv)
    hdr = huf.huf_write_ctable(hct, max_sv)
    hblob = huf.huf_compress(data)
    # smaller counts for the tiny-table builds (reference uses tableLog 6/9/10)
    norm10, _ = fse_normalize_count(10, count[: max_sv + 1], n, max_sv)
    norm9, _ = fse_normalize_count(9, count[: max_sv + 1], n, max_sv)

    def small_dst():
        # reference local_FSE_compress_usingCTable_tooSmall: dst = src/2
        try:
            return fse.fse_compress_using_ctable(data, ct, dst_capacity=n // 2)
        except FSEError:
            return b""

    stages = {
        1: ("HIST_count(255)", lambda: hist_count(src, 255), n),
        2: ("HIST_count(254)", lambda: hist_count(src, 254), n),
        # the twin has one (trusted) counting path; countFast == count here
        3: ("HIST_countFast(254)", lambda: hist_count(src, 254), n),
        4: ("FSE_normalizeCount",
            lambda: fse_normalize_count(tlog, count[: max_sv + 1], n, max_sv), n),
        5: ("FSE_writeNCount", lambda: fse_write_ncount(norm, max_sv, tlog), n),
        6: ("FSE_buildCTable", lambda: build_ctable(norm, max_sv, tlog), n),
        7: ("FSE_compress_usingCTable",
            lambda: fse.fse_compress_using_ctable(data, ct), n),
        8: ("FSE_compress_usingCTable_smallDst", small_dst, n),
        9: ("FSE_compress", lambda: fse.fse_compress(data), n),
        11: ("FSE_readNCount", lambda: fse_read_ncount(nc + b"\0" * 8), n),
        12: ("FSE_buildDTable", lambda: build_dtable(norm, max_sv, tlog), n),
        13: ("FSE_decompress_usingDTable",
             lambda: fse.fse_decompress_using_dtable(payload, dt, n), n),
        20: ("HUF_compress", lambda: huf.huf_compress(data), n),
        21: ("HUF_buildCTable", lambda: huf.huf_build_ctable(count, max_sv), n),
        22: ("HUF_writeCTable", lambda: huf.huf_write_ctable(hct, max_sv), n),
        23: ("HUF_compress4x_usingCTable",
             lambda: huf.huf_compress_4x_using_ctable(data, hct, 2 * n), n),
        25: ("HUF_readCTable", lambda: huf.huf_read_ctable(hdr), n),
        31: ("HUF_readStats", lambda: huf.huf_read_stats(hdr), n),
        70: ("FSE_buildCTable_raw(6)", lambda: build_ctable_raw(6), n),
        80: ("FSE_buildDTable(10)",
             lambda: build_dtable(norm10, max_sv, 10), n),
        81: ("FSE_buildDTable(9)", lambda: build_dtable(norm9, max_sv, 9), n),
        82: ("FSE_buildDTable_raw(6)", lambda: build_dtable_raw(6), n),
    }
    fblob = fse.fse_compress(data)
    if fblob.kind.name == "COMPRESSED":
        fb = fblob.data
        stages[14] = ("FSE_decompress", lambda: fse.fse_decompress(fb, n), n)
    if hblob.kind.name == "COMPRESSED":
        hb = hblob.data
        dt1 = huf.huf_read_dtable_x1(hb)[0]
        dt2 = huf.huf_read_dtable_x2(hb)[0]
        used1 = huf.huf_read_dtable_x1(hb)[1]
        used2 = huf.huf_read_dtable_x2(hb)[1]
        body1, body2 = hb[used1:], hb[used2:]
        one = huf.huf_compress(data, four_streams=False)
        stages.update({
            30: ("HUF_decompress", lambda: huf.huf_decompress(hb, n), n),
            32: ("HUF_readDTable(X1)",
                 lambda: huf.huf_read_dtable_x1(hb), n),
            33: ("HUF_decompress_usingDTable(X1)",
                 lambda: huf.huf_decompress_4x1_using_dtable(body1, n, dt1), n),
            40: ("HUF_decompress4X1",
                 lambda: huf.huf_decompress_4x1(hb, n), n),
            41: ("HUF_readDTableX1", lambda: huf.huf_read_dtable_x1(hb), n),
            42: ("HUF_decompress4X1_usingDTable",
                 lambda: huf.huf_decompress_4x1_using_dtable(body1, n, dt1), n),
            50: ("HUF_decompress4X2",
                 lambda: huf.huf_decompress_4x2(hb, n), n),
            51: ("HUF_readDTableX2", lambda: huf.huf_read_dtable_x2(hb), n),
            52: ("HUF_decompress4X2_usingDTable",
                 lambda: huf.huf_decompress_4x2_using_dtable(body2, n, dt2), n),
        })
        if one.kind.name == "COMPRESSED":
            ob = one.data
            odt1, oused1 = huf.huf_read_dtable_x1(ob)[:2]
            odt2, oused2 = huf.huf_read_dtable_x2(ob)[:2]
            obody1, obody2 = ob[oused1:], ob[oused2:]
            stages.update({
                45: ("HUF_decompress1X1",
                     lambda: huf.huf_decompress_1x1(ob, n), n),
                46: ("HUF_decompress1X1_usingDTable",
                     lambda: huf.huf_decompress_1x1_using_dtable(
                         obody1, n, odt1), n),
                55: ("HUF_decompress1X2",
                     lambda: huf.huf_decompress_1x2(ob, n), n),
                56: ("HUF_decompress1X2_usingDTable",
                     lambda: huf.huf_decompress_1x2_using_dtable(
                         obody2, n, odt2), n),
            })
    return stages


def _groups(a: np.ndarray, G: int, dev: torch.device) -> torch.Tensor:
    """G copies of one group's array as an int32 tensor on dev (u32 arrays
    keep their bit patterns), built on the device."""
    a = np.ascontiguousarray(a)
    a = a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32)
    t = torch.from_numpy(a).to(dev)
    return t.unsqueeze(0).expand(G, *t.shape).contiguous()


def _turbo_stages(groups: int = 16, group_size: int = 1 << 20, device=None):
    """The TurboRANS kernel stages on `groups` copies of a group of
    group_size bytes, the wrappers' inputs built on `device` (CUDA unless
    named).  A device stage's callable takes interpret (default False):
    True runs the plain versions on the same inputs.  The windowed decodes
    (206, 208, 209) need t4 a multiple of S: groups of 256 KiB and up for
    206 and 208, 512 KiB for 209."""
    from ..turbo.api import _hrows_cap, _prep_group, _round8
    from ..turbo.format import TURBO_STEP_SYMS, _pad_n
    from ..turbo.rans_kernels import (rans_decode, rans_decode_v2,
                                      rans_decode_w, rans_encode,
                                      rans_encode2)
    from ..turbo.state import resolve_device
    from ..turbo.tables import (pack_rans_ctables, pack_rans_dtable,
                                pack_stream_words, stream_word_rows)

    dev = resolve_device(device)
    gsz = group_size
    base = generate_proba(P_DEFAULT)
    data = (base * ((gsz // len(base)) + 1))[:gsz]
    src = np.frombuffer(data, np.uint8)
    norm, max_sv, ncount, mfs = _prep_group(src)
    n_pad = _pad_n(gsz)
    t4 = n_pad // TURBO_STEP_SYMS
    hcap = _hrows_cap(n_pad)
    fc, mg = pack_rans_ctables(norm)
    G = groups
    fcb, mgb = _groups(fc, G, dev), _groups(mg, G, dev)
    pad = np.full(n_pad, mfs, np.uint8)
    pad[:gsz] = src
    srcw = _groups(pad.view("<u4").view(np.int32).reshape(t4 * 8, 128), G, dev)

    stream, fin, csize, _stots = rans_encode2(fcb, mgb, srcw, t4, hcap)
    cs = int(csize[0])
    hrows = _round8((cs + 127) // 128 + 16)
    srows = stream_word_rows(hrows)
    payload = stream[0].cpu().numpy().tobytes()[: 2 * cs]
    dargs = (torch.full((G,), cs, dtype=torch.int32, device=dev),
             _groups(pack_rans_dtable(norm), G, dev),
             _groups(fin[0].cpu().numpy(), G, dev),
             _groups(pack_stream_words(payload, srows), G, dev))
    rans_decode(*dargs, t4, hrows)
    dargs2 = dargs + (_groups(_stots[0].cpu().numpy(), G, dev),)
    rans_decode_v2(*dargs2, t4, hrows)

    total = G * gsz
    # device kernel stages return the wrapper's outputs unsynced; main()
    # times them with the queue-k method (_calibrated_device) — the
    # "device" marker
    return {
        200: ("turbo_rans_encode (kernel)",
              lambda interpret=False: rans_encode2(fcb, mgb, srcw, t4, hcap,
                                                   interpret),
              total, "device"),
        205: ("turbo_rans_encode (kernel, v1 halfword-out)",
              lambda interpret=False: rans_encode(fcb, mgb, srcw, t4, hcap,
                                                  interpret),
              total, "device"),
        201: ("turbo_rans_decode (kernel)",
              lambda interpret=False: rans_decode(*dargs, t4, hrows,
                                                  interpret),
              total, "device"),
        202: ("rans table pack (host)", lambda: pack_rans_dtable(norm), gsz),
        203: ("group prep (hist+norm+ncount)", lambda: _prep_group(src), gsz),
        204: ("turbo_rans_decode (kernel, v2)",
              lambda interpret=False: rans_decode_v2(*dargs2, t4, hrows,
                                                     interpret),
              total, "device"),
        206: ("turbo_rans_decode (kernel, HBM-windowed 8-way S=64)",
              lambda interpret=False: rans_decode_w(*dargs2, t4, hrows, 8, 11,
                                                    64, interpret),
              total, "device"),
        207: ("turbo_rans_encode (kernel, row-local placement)",
              lambda interpret=False: rans_encode2(fcb, mgb, srcw, t4, hcap,
                                                   interpret, False, 11, True,
                                                   0, True),
              total, "device"),
        **_multibyte_stages(G, group_size=gsz, device=dev),
    }


def _multibyte_stages(G, group_size: int = 1 << 20, device=None):
    """The pair and quad wires (stages 208/209/215): the main path's
    multi-byte decode and encode kernels on a Proba80 group, G copies on
    `device`."""
    from ..turbo.api import _round8
    from ..turbo.pair import PAIR_TABLELOG, pair_compress, parse_pair_group
    from ..turbo.quad import (QUAD_TABLELOG, _pad_q, parse_quad_group,
                              prep_quad_group, quad_compress)
    from ..turbo.rans16 import _pad_n16
    from ..turbo.rans_kernels import rans_decode_w, rans_encode2
    from ..turbo.state import resolve_device
    from ..turbo.tables import (pack_pair_dtable, pack_quad_dtable,
                                pack_rans_ctables, pack_stream_words,
                                stream_word_rows)

    dev = resolve_device(device)
    gsz = group_size
    # p80: the multi-byte wires need a cappable super-symbol alphabet
    # (P_DEFAULT=20% is pair/quad-INELIGIBLE by design — the dispatch
    # falls back to the byte wire there)
    base = generate_proba(80)
    data = bytes((base * ((gsz // len(base)) + 1))[:gsz])
    total = G * gsz

    pb = pair_compress(data, table_log=PAIR_TABLELOG)
    if pb is None:
        return {}
    (n, cs, tl, fl, norm, msv, init, payload, stots, pairs,
     _e), _ = parse_pair_group(pb)
    t2 = _pad_n16((n + 1) // 2) // 2048
    hrows = _round8((cs + 127) // 128 + 16)
    srows = stream_word_rows(hrows)
    dp = (torch.full((G,), cs, dtype=torch.int32, device=dev),
          _groups(pack_pair_dtable(norm, pairs, tl), G, dev),
          _groups(init.view(np.int32).reshape(8, 128), G, dev),
          _groups(pack_stream_words(payload, srows), G, dev),
          _groups(stots.astype(np.int32), G, dev))

    qb = quad_compress(data, table_log=QUAD_TABLELOG)
    (qn, qcs, qtl, _qf, qnorm, _qm, qinit, qpay, qst, quads,
     _qe), _ = parse_quad_group(qb)
    steps = _pad_q((qn + 3) // 4) // 1024
    qhrows = _round8((qcs + 127) // 128 + 16)
    qsrows = stream_word_rows(qhrows)
    dq = (torch.full((G,), qcs, dtype=torch.int32, device=dev),
          _groups(pack_quad_dtable(qnorm, quads, qtl), G, dev),
          _groups(qinit.view(np.int32).reshape(8, 128), G, dev),
          _groups(pack_stream_words(qpay, qsrows), G, dev),
          _groups(qst.astype(np.int32), G, dev))

    qp = prep_quad_group(data)
    qid_pad = _pad_q(len(qp["ids"]))
    qfc, qmg = pack_rans_ctables(qp["norm"])
    qpad = np.full(qid_pad, qp["mfi"], np.uint32)
    qpad[: len(qp["ids"])] = qp["ids"]
    qea = (_groups(qfc, G, dev), _groups(qmg, G, dev),
           _groups(qpad.astype("<u4").view(np.int32).reshape(steps * 8, 128),
                   G, dev))
    qhcap = _round8((qid_pad + 127) // 128 + 16)

    return {
        208: ("turbo PAIR decode (kernel, windowed 8-way — r5)",
              lambda interpret=False: rans_decode_w(*dp, t2, hrows, 8, tl, 64,
                                                    interpret, True, False,
                                                    True),
              total, "device"),
        209: ("turbo QUAD decode (kernel, windowed 8-way S=128 — r5 "
              "production default on p80)",
              lambda interpret=False: rans_decode_w(*dq, steps, qhrows, 8, qtl,
                                                    128, interpret, False,
                                                    False, False, True),
              total, "device"),
        215: ("turbo QUAD encode (kernel, spc=1 rowloc — r5)",
              lambda interpret=False: rans_encode2(*qea, steps, qhcap,
                                                   interpret, False, qtl, True,
                                                   0, True, True),
              total, "device"),
    }


def _device_compat_stages(blocks: int = 64, block_size: int = 32768,
                          device=None):
    """The batched compat (wire-identical) device codecs on `blocks` blocks
    of block_size bytes of Proba20, on `device` (CUDA unless named; "cpu"
    runs the plain versions).  The JAX module cuts the 64 blocks from a
    1048575-byte buffer and so times 32; the port generates all 64 (the
    same bytes, then more of the stream)."""
    from ..models.fse_codec import FseTpuCodec
    from ..models.huf_codec import HufTpuCodec

    bs = block_size
    nblk = blocks
    data = generate_proba(P_DEFAULT, bs * nblk)
    blocks = [data[i: i + bs] for i in range(0, len(data), bs)]
    fse_c = FseTpuCodec(block_size=bs, device=device)
    huf_c = HufTpuCodec(block_size=bs, device=device)
    huf_x2 = HufTpuCodec(block_size=bs, decoder="x2", device=device)
    fres = fse_c.compress_blocks(blocks)
    hres = huf_c.compress_blocks(blocks)
    fitems = [(r.data, len(b)) for b, r in zip(blocks, fres)
              if r.kind.name == "COMPRESSED"]
    hitems = [(r.data, len(b)) for b, r in zip(blocks, hres)
              if r.kind.name == "COMPRESSED"]
    n = len(data)
    return {
        210: ("device fse_encode_batch (compat)",
              lambda: fse_c.compress_blocks(blocks), n),
        211: ("device fse_decode_batch (compat)",
              lambda: fse_c.decompress_blocks(fitems), bs * len(fitems)),
        212: ("device huf_encode_4x_batch (compat)",
              lambda: huf_c.compress_blocks(blocks), n),
        213: ("device huf_decode_4x1_batch (compat)",
              lambda: huf_c.decompress_blocks(hitems), bs * len(hitems)),
        214: ("device huf_decode_4x2_batch (compat)",
              lambda: huf_x2.decompress_blocks(hitems), bs * len(hitems)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fullbench")
    ap.add_argument("stages", nargs="*", type=int)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the stages >= 200 run (default cuda)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    want = args.stages or None

    stages = _stages()
    if want is None or any(w >= 200 for w in want):
        if args.device == "cuda" and not torch.cuda.is_available():
            print("fullbench: the stages >= 200 run on CUDA and no CUDA "
                  "device is available; pass --device cpu to run them on "
                  "the CPU", file=sys.stderr)
            return 1
        stages.update(_turbo_stages(device=args.device))
        stages.update(_device_compat_stages(device=args.device))

    for num in sorted(stages):
        if want and num not in want:
            continue
        name, fn, payload = stages[num][:3]
        if len(stages[num]) > 3 and stages[num][3] == "device":
            rate = _calibrated_device(fn, payload)
        else:
            rate = _calibrated(fn, payload)
        print(f"{num:3d} {name:38s} {rate/1e6:10.1f} MB/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
