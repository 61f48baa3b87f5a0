"""FSE codec pipeline: host stats and headers, then the batched device coder.

The port of the JAX package's models/fse_codec.py.  Histograms, the
normalization and the NCount headers are small sequential work done on the
host in numpy; the table build (ops/fse_tables.py, torch ops) and the state
chains (ops/fse_kernels.py, the CUDA kernels) run batched on the codec's
device, one launch a side for a whole batch.  The raw / RLE decisions are
the JAX codec's, so the frames are byte-identical to the host twin's.

``stage_seconds`` (off by default) times the stages of every codec call,
as turbo/api.py's does: set it to a dict and each stage adds its seconds
under its name ("c_prep", "c_stage", "c_h2d", "c_tables", "c_encode",
"c_d2h", "c_frames"; "d_parse", "d_h2d", "d_tables", "d_decode", "d_d2h",
"d_out"), a device stage ending in a sync.  The Huff0 codec records
into the same dict.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..config import FSE_DEFAULT_TABLELOG, fse_blockbound
from ..errors import CorruptionError
from ..parallel.mesh import Mesh, get_mesh
from ..refimpl.blocktypes import BlockResult
from ..refimpl.ncount import fse_read_ncount, fse_write_ncount
from ..refimpl.norm import fse_normalize_count, fse_optimal_table_log
from ..turbo.state import resolve_device

stage_seconds: dict | None = None


class _Stages:
    """Adds each stage's seconds to stage_seconds while it is a dict."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.t = time.perf_counter()

    def mark(self, name: str, sync: bool = False) -> None:
        if stage_seconds is None:
            return
        if sync and self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        stage_seconds[name] = stage_seconds.get(name, 0.0) + now - self.t
        self.t = now


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _pad_batch(arrs, m: int):
    """Pad each array's leading dim to a multiple of m by repeating row 0
    (dummy blocks decode to garbage that callers slice away)."""
    B = arrs[0].shape[0]
    pad = (-B) % m
    if pad == 0:
        return arrs
    return [np.concatenate([a, np.repeat(a[:1], pad, axis=0)]) for a in arrs]


def _codec_mesh(mesh, dev: torch.device) -> Mesh | None:
    """The codec's mesh: a Mesh as given, else get_mesh(mesh) for mesh > 1
    (None, with a warning, when fewer devices are attached)."""
    if isinstance(mesh, Mesh):
        return mesh
    return get_mesh(mesh, dev) if mesh and mesh > 1 else None


def _pull_words(words: torch.Tensor, sizes: np.ndarray) -> np.ndarray:
    """The leading words of each row that hold sizes' bytes, on the host."""
    n = max((int(sizes.max()) + 3) >> 2, 1) if sizes.size else 1
    return words[..., :n].cpu().numpy()


class FseTpuCodec:
    """Batched FSE coder.  `mesh` > 1 shards the block batch data-parallel
    over that many devices (parallel/dp.py; falls back to one device with a
    warning when fewer are attached); a parallel.mesh.Mesh is used as
    given.  device: None runs on CUDA (raises without it), "cpu" runs the
    kernels' plain versions."""

    def __init__(self, block_size: int = 32768, mesh: int = 0, device=None):
        self.block_size = block_size
        self.mesh = mesh
        self.device = resolve_device(device)

    def _get_mesh(self):
        return _codec_mesh(self.mesh, self.device)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- compression ------------------------------------------------------

    def encode_plan(self, blocks):
        """Host stats, heuristics, normalization and headers: (results with
        the raw / RLE blocks decided, todo = [(index, block, norm,
        tableLog, header)] for the coder)."""
        results: list[BlockResult | None] = [None] * len(blocks)
        todo = []
        for i, b in enumerate(blocks):
            n = len(b)
            if n <= 1:
                results[i] = BlockResult.raw()
                continue
            arr = np.frombuffer(b, dtype=np.uint8)
            count = np.bincount(arr, minlength=256)
            max_sv = int(arr.max())
            max_count = int(count.max())
            if max_count == n:
                results[i] = BlockResult.rle()
                continue
            if max_count == 1 or max_count < (n >> 7):
                results[i] = BlockResult.raw()
                continue
            tlog = fse_optimal_table_log(FSE_DEFAULT_TABLELOG, n, max_sv)
            norm, tlog = fse_normalize_count(tlog, count[: max_sv + 1], n, max_sv)
            if norm is None:
                results[i] = BlockResult.rle()
                continue
            header = fse_write_ncount(norm, max_sv, tlog)
            todo.append((i, b, norm, tlog, header))
        return results, todo

    def encode_inputs(self, todo) -> dict:
        """The encode's padded numpy inputs of encode_plan's todo: src[B, S],
        n[B], norm[B, 256], tlog[B], and max_syms, out_bytes."""
        B = len(todo)
        S = _round_up(self.block_size, 8)
        src = np.zeros((B, S), dtype=np.uint8)
        norms = np.zeros((B, 256), dtype=np.int32)
        tlogs = np.zeros(B, dtype=np.int32)
        ns = np.zeros(B, dtype=np.int32)
        for k, (_i, b, norm, tlog, _hdr) in enumerate(todo):
            src[k, : len(b)] = np.frombuffer(b, dtype=np.uint8)
            norms[k, : len(norm)] = norm
            tlogs[k] = tlog
            ns[k] = len(b)
        return dict(src=src, n=ns, norm=norms, tlog=tlogs, max_syms=S,
                    out_bytes=_round_up(fse_blockbound(self.block_size), 8))

    def compress_blocks(self, blocks):
        from ..ops import fse_kernels, fse_tables

        st = _Stages(self.device)
        results, todo = self.encode_plan(blocks)
        st.mark("c_prep")
        if todo:
            e = self.encode_inputs(todo)
            B, S, out_bytes = len(todo), e["max_syms"], e["out_bytes"]
            st.mark("c_stage")
            mesh = self._get_mesh()
            if mesh is not None:
                from ..parallel.dp import sharded_encode

                padded = _pad_batch([e["src"], e["n"], e["norm"], e["tlog"]],
                                    mesh.devices.size)
                words, csize, _total = sharded_encode(mesh, S, out_bytes)(*padded)
                st.mark("c_encode", sync=True)
            else:
                src, ns, norms, tlogs = (self._tensor(e[k]) for k in
                                         ("src", "n", "norm", "tlog"))
                st.mark("c_h2d", sync=True)
                ctables = fse_tables.build_ctables(norms, tlogs)
                st.mark("c_tables", sync=True)
                words, csize = fse_kernels.fse_encode_batch(
                    src, ns, tlogs, ctables, max_syms=S, out_bytes=out_bytes)
                st.mark("c_encode", sync=True)
            csize = csize[:B].cpu().numpy()
            words = _pull_words(words[:B], csize)
            st.mark("c_d2h")
            for k, (i, b, _norm, _tlog, hdr) in enumerate(todo):
                payload = words[k].astype("<i4").tobytes()[: csize[k]]
                if csize[k] == 0 or len(hdr) + len(payload) >= len(b) - 1:
                    results[i] = BlockResult.raw()
                else:
                    results[i] = BlockResult.compressed(hdr + payload)
            st.mark("c_frames")
        return results

    # -- decompression ----------------------------------------------------

    def decode_inputs(self, items) -> dict:
        """The decode's padded numpy inputs of the frame's compressed blocks
        [(payload, regenerated size)]: streams[B, S], csize[B], n_out[B],
        norm[B, 256], tlog[B], and max_out."""
        B = len(items)
        S = _round_up(fse_blockbound(self.block_size) + 8, 8)
        streams = np.zeros((B, S), dtype=np.uint8)
        norms = np.zeros((B, 256), dtype=np.int32)
        tlogs = np.zeros(B, dtype=np.int32)
        csize = np.zeros(B, dtype=np.int32)
        nout = np.zeros(B, dtype=np.int32)
        for k, (payload, rsize) in enumerate(items):
            norm, _max_sv, tlog, used = fse_read_ncount(payload)
            body = payload[used:]
            if len(body) > S:
                raise CorruptionError("fse payload larger than bound")
            streams[k, : len(body)] = np.frombuffer(body, dtype=np.uint8)
            norms[k, : len(norm)] = norm
            tlogs[k] = tlog
            csize[k] = len(body)
            nout[k] = rsize
        return dict(streams=streams, csize=csize, n_out=nout, norm=norms,
                    tlog=tlogs, max_out=_round_up(self.block_size, 8))

    def decompress_blocks(self, items):
        from ..ops import fse_kernels, fse_tables

        if not items:
            return []
        st = _Stages(self.device)
        B = len(items)
        d = self.decode_inputs(items)
        max_out = d["max_out"]
        st.mark("d_parse")
        mesh = self._get_mesh()
        if mesh is not None:
            from ..parallel.dp import sharded_decode

            padded = _pad_batch([d[k] for k in ("streams", "csize", "n_out", "norm",
                                                "tlog")], mesh.devices.size)
            out, err = sharded_decode(mesh, max_out)(*padded)
            st.mark("d_decode", sync=True)
        else:
            streams, csize, nout, norms, tlogs = (
                self._tensor(d[k]) for k in ("streams", "csize", "n_out", "norm", "tlog"))
            st.mark("d_h2d", sync=True)
            dtables = fse_tables.build_dtables(norms, tlogs)
            st.mark("d_tables", sync=True)
            out, err = fse_kernels.fse_decode_batch(streams, csize, nout, tlogs,
                                                    dtables[:3], max_out=max_out)
            st.mark("d_decode", sync=True)
        err = err[:B].cpu().numpy()
        bad = np.flatnonzero(err)
        if bad.size:
            raise CorruptionError(f"fse block {bad[0]}: bitstream accounting failed")
        out = out[:B].cpu().numpy()
        st.mark("d_d2h")
        res = [out[k, :rsize].tobytes() for k, (_payload, rsize) in enumerate(items)]
        st.mark("d_out")
        return res
