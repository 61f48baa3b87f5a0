"""Huff0 codec pipeline: host tree and headers, then the batched device
4-stream coder.

The port of the JAX package's models/huf_codec.py.  The tree build, length
limiting and weight header are 256-symbol host work (refimpl/huf.py); the
per-symbol encode and the 4-stream decode chains run on the codec's
device (ops/huf_kernels.py, the CUDA kernels), one launch a side for a
whole batch.  X1 and X2 decode the same bytes; the X2 tables are built on
the host per block (huf_read_dtable_x2 + pack_dtable_x2), as in the JAX
package.  Each stage is the span "huf.<stage>" and adds its seconds to
fse_codec.stage_seconds while that is a dict (fse_codec._stage).
``counts`` tallies the blocks of each call: how compress_blocks stored
them ("coded", "raw", "rle") and which path decompress_blocks decoded them
on ("decoded_x1", "decoded_x2", "decoded_mesh").
"""
from __future__ import annotations

import threading
from collections import Counter

import numpy as np
import torch

from ..config import HUF_TABLELOG_DEFAULT, huf_blockbound
from ..errors import CorruptionError
from ..refimpl.blocktypes import BlockResult, Kind
from ..refimpl.hist import hist_count
from ..refimpl.huf import huf_build_ctable, huf_read_stats, huf_write_ctable
from ..refimpl.norm import fse_optimal_table_log
from ..turbo.state import resolve_device
from .fse_codec import _codec_mesh, _pad_batch, _pull_words, _round_up, _stage

counts = {"coded": 0, "raw": 0, "rle": 0,
          "decoded_x1": 0, "decoded_x2": 0, "decoded_mesh": 0}
_counts_lock = threading.Lock()
_KIND_KEY = {Kind.COMPRESSED: "coded", Kind.RAW: "raw", Kind.RLE: "rle"}


def _count(added: dict) -> None:
    """Add a call's blocks, {key: blocks}, to counts."""
    with _counts_lock:
        for k, n in added.items():
            counts[k] += n


class HufTpuCodec:
    """Batched Huff0 coder.  `mesh` > 1 shards the block batch data-parallel
    over that many devices (parallel/dp.py); a parallel.mesh.Mesh is used
    as given.

    decoder: "x1" (default) or "x2", the same bytes; X2 packs up to two
    symbols a lookup (huf_decompress.c:454-953).  As in the JAX codec
    there is no ratio-based auto-switch.  device: None runs on CUDA
    (raises without it), "cpu" runs the kernels' plain versions."""

    def __init__(self, block_size: int = 32768, mesh: int = 0,
                 decoder: str = "x1", device=None):
        if decoder not in ("x1", "x2"):
            raise ValueError(f"unknown decoder {decoder!r}")
        self.block_size = block_size
        self.mesh = mesh
        self.decoder = decoder
        self.device = resolve_device(device)

    def _get_mesh(self):
        return _codec_mesh(self.mesh, self.device)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- compression ------------------------------------------------------

    def encode_plan(self, blocks):
        """Host tree, length limits and headers: (results with the raw /
        RLE blocks decided, todo = [(index, block, header, val[256],
        nb[256])] for the coder)."""
        results: list[BlockResult | None] = [None] * len(blocks)
        todo = []
        for i, b in enumerate(blocks):
            n = len(b)
            if n == 0 or n < 12:
                results[i] = BlockResult.raw()
                continue
            count, max_sv, largest = hist_count(b)
            if largest == n:
                results[i] = BlockResult.rle()
                continue
            if largest <= (n >> 7) + 4:
                results[i] = BlockResult.raw()
                continue
            huff_log = fse_optimal_table_log(HUF_TABLELOG_DEFAULT, n, max_sv, minus=1,
                                             max_allowed=12)
            table = huf_build_ctable(count, max_sv, huff_log)
            header = huf_write_ctable(table, max_sv)
            if len(header) + 12 >= n:
                results[i] = BlockResult.raw()
                continue
            val = np.zeros(256, dtype=np.int32)
            nb = np.zeros(256, dtype=np.int32)
            val[: max_sv + 1] = table.val
            nb[: max_sv + 1] = table.nb_bits
            todo.append((i, b, header, val, nb))
        return results, todo

    def encode_inputs(self, todo) -> dict:
        """The encode's padded numpy inputs of encode_plan's todo: src[B, S],
        n[B], val[B, 256], nb[B, 256] (int32), and max_block, seg_bytes."""
        B = len(todo)
        S = _round_up(self.block_size, 8)
        src = np.zeros((B, S), dtype=np.uint8)
        ns = np.zeros(B, dtype=np.int32)
        vals = np.zeros((B, 256), dtype=np.int32)
        nbs = np.zeros((B, 256), dtype=np.int32)
        for k, (_i, b, _h, val, nb) in enumerate(todo):
            src[k, : len(b)] = np.frombuffer(b, dtype=np.uint8)
            ns[k] = len(b)
            vals[k] = val
            nbs[k] = nb
        return dict(src=src, n=ns, val=vals, nb=nbs, max_block=S,
                    seg_bytes=_round_up(huf_blockbound((self.block_size + 3) // 4) + 8, 8))

    def compress_blocks(self, blocks):
        from ..ops import huf_kernels

        dev = self.device
        with _stage("huf.c_prep", dev):
            results, todo = self.encode_plan(blocks)
        if not todo:
            _count(Counter(_KIND_KEY[r.kind] for r in results))
            return results
        with _stage("huf.c_stage", dev):
            e = self.encode_inputs(todo)
            B, S, seg_bytes = len(todo), e["max_block"], e["seg_bytes"]
            arrays = [e[k] for k in ("src", "n", "val", "nb")]
            mesh = self._get_mesh()
        if mesh is not None:
            from ..parallel.dp import sharded_huf_encode

            with _stage("huf.c_encode", dev, sync=True):
                padded = _pad_batch(arrays, mesh.devices.size)
                words, sizes = sharded_huf_encode(mesh, S, seg_bytes)(*padded)
        else:
            with _stage("huf.c_h2d", dev, sync=True):
                ins = [self._tensor(a) for a in arrays]
            with _stage("huf.c_encode", dev, sync=True):
                words, sizes = huf_kernels.huf_encode_4x_batch(*ins, S, seg_bytes)
        with _stage("huf.c_d2h", dev):
            sizes = sizes[:B].cpu().numpy()
            words = _pull_words(words[:B], sizes)
        with _stage("huf.c_frames", dev):
            for k, (i, b, header, _v, _nb) in enumerate(todo):
                s = sizes[k]
                if np.any(s == 0) or s[0] > 65535 or s[1] > 65535 or s[2] > 65535:
                    results[i] = BlockResult.raw()
                    continue
                jump = b"".join(int(s[j]).to_bytes(2, "little") for j in range(3))
                streams = b"".join(
                    words[k, j].astype("<i4").tobytes()[: s[j]] for j in range(4))
                payload = header + jump + streams
                if len(payload) >= len(b) - 1:
                    results[i] = BlockResult.raw()
                else:
                    results[i] = BlockResult.compressed(payload)
        _count(Counter(_KIND_KEY[r.kind] for r in results))
        return results

    # -- decompression ----------------------------------------------------

    def decode_inputs(self, items) -> dict:
        """The decode's padded numpy inputs of the frame's compressed blocks
        [(payload, regenerated size)]: four stream rows a block, streams[4B,
        S], csize[4B], n_out[4B], tlog[4B]; weights[B, 256], segs[B], and
        with the x2 decoder the host-built tables x2_tbl[B, 4096] and
        x2_tlog[B]; max_seg."""
        from ..ops.huf_kernels import pack_dtable_x2
        from ..refimpl.huf import huf_read_dtable_x2

        seg_cap = (self.block_size + 3) // 4
        S = _round_up(huf_blockbound(seg_cap) + 8, 8)
        B = len(items)
        streams = np.zeros((B * 4, S), dtype=np.uint8)
        csize = np.zeros(B * 4, dtype=np.int32)
        nout = np.zeros(B * 4, dtype=np.int32)
        tlogs = np.zeros(B * 4, dtype=np.int32)
        weights = np.zeros((B, 256), dtype=np.int32)
        x2 = self.decoder == "x2"
        x2_tbl = np.zeros((B, 4096), dtype=np.int32) if x2 else None
        x2_tlogs = np.zeros(B, dtype=np.int32)
        segs = np.zeros(B, dtype=np.int32)
        for k, (payload, rsize) in enumerate(items):
            if x2:
                dt2, _used2 = huf_read_dtable_x2(payload)
                x2_tbl[k] = pack_dtable_x2(dt2)
                x2_tlogs[k] = dt2.table_log
            w, _rank_stats, _nbsym, tlog, used = huf_read_stats(payload)
            body = payload[used:]
            if len(body) < 10:
                raise CorruptionError("huf 4X: input too small")
            l1 = int.from_bytes(body[0:2], "little")
            l2 = int.from_bytes(body[2:4], "little")
            l3 = int.from_bytes(body[4:6], "little")
            l4 = len(body) - 6 - l1 - l2 - l3
            if l4 < 0:
                raise CorruptionError("huf 4X: jump table overflow")
            seg = (rsize + 3) // 4
            segs[k] = seg
            pos = 6
            for j, sl in enumerate((l1, l2, l3, l4)):
                if sl > S:
                    raise CorruptionError("huf stream larger than bound")
                streams[4 * k + j, :sl] = np.frombuffer(body[pos: pos + sl], dtype=np.uint8)
                csize[4 * k + j] = sl
                nout[4 * k + j] = seg if j < 3 else rsize - 3 * seg
                tlogs[4 * k + j] = tlog
                pos += sl
            weights[k, : len(w)] = np.frombuffer(w, dtype=np.uint8)
        return dict(streams=streams, csize=csize, n_out=nout, tlog=tlogs,
                    weights=weights, segs=segs, x2_tbl=x2_tbl, x2_tlog=x2_tlogs,
                    max_seg=seg_cap)

    def decompress_blocks(self, items):
        from ..ops import huf_kernels

        if not items:
            return []
        dev = self.device
        with _stage("huf.d_parse", dev):
            B = len(items)
            # raw/rle shortcuts (cSrc==dst / 1 byte) are frame-level; here every
            # payload is header + jumpTable + 4 streams
            d = self.decode_inputs(items)
            seg_cap, tlogs, weights = d["max_seg"], d["tlog"], d["weights"]
            mesh = self._get_mesh()
        # device: tables per block, repeated x4 for the stream axis
        path = "decoded_x2" if self.decoder == "x2" else (
            "decoded_mesh" if mesh is not None else "decoded_x1")
        if path == "decoded_mesh":
            from ..parallel.dp import sharded_huf_decode

            with _stage("huf.d_decode", dev, sync=True):
                # pad the block dim to the mesh; stream rows pad 4 at a time so
                # each dummy block carries its 4 streams
                weightsp, = _pad_batch([weights], mesh.devices.size)
                Bp = weightsp.shape[0]

                def rep4(a):
                    return (np.concatenate([a, np.tile(a[:4], (Bp - B,) + (1,) * (a.ndim - 1))])
                            if Bp > B else a)
                out, err = sharded_huf_decode(mesh, seg_cap)(
                    *(rep4(d[k]) for k in ("streams", "csize", "n_out", "tlog")), weightsp,
                    np.resize(tlogs.reshape(B, 4)[:, 0], Bp))
        elif path == "decoded_x2":
            with _stage("huf.d_h2d", dev, sync=True):
                args = [self._tensor(d[k]) for k in ("streams", "csize", "n_out")]
                tl4 = self._tensor(np.repeat(d["x2_tlog"], 4))
                tbl4 = self._tensor(np.repeat(d["x2_tbl"], 4, axis=0))
            with _stage("huf.d_decode", dev, sync=True):
                out, err = huf_kernels.huf_decode_4x2_batch(*args, tl4, tbl4,
                                                            max_seg=seg_cap)
        else:
            with _stage("huf.d_h2d", dev, sync=True):
                args = [self._tensor(d[k]) for k in ("streams", "csize", "n_out")]
                tl4, w = self._tensor(tlogs), self._tensor(weights)
                tl_blocks = self._tensor(tlogs.reshape(B, 4)[:, 0])
            with _stage("huf.d_tables", dev, sync=True):
                byte_tbl, nb_tbl = huf_kernels.build_dtables_x1(w, tl_blocks)
                tables = (byte_tbl.repeat_interleave(4, dim=0),
                          nb_tbl.repeat_interleave(4, dim=0))
            with _stage("huf.d_decode", dev, sync=True):
                out, err = huf_kernels.huf_decode_4x1_batch(*args, tl4, tables,
                                                            max_seg=seg_cap)
        with _stage("huf.d_d2h", dev):
            err = err[: 4 * B].cpu().numpy().reshape(B, 4)
            bad = np.flatnonzero(err.any(axis=1))
            if bad.size:
                raise CorruptionError(f"huf block {bad[0]}: stream not fully consumed")
            out = out[: 4 * B].cpu().numpy()
        with _stage("huf.d_out", dev):
            res = []
            segs = d["segs"]
            for k, (_payload, rsize) in enumerate(items):
                seg = segs[k]
                parts = [out[4 * k + j, : (seg if j < 3 else rsize - 3 * seg)]
                         for j in range(4)]
                res.append(np.concatenate(parts).tobytes())
        _count({path: B})
        return res
