"""Data-parallel sharded steps of the compat codecs (FSE and Huff0).

The port of the JAX package's parallel/dp.py, on turbo_dp's machinery:
blocks shard over the mesh's devices; tables are built per block on each
shard's device (so they shard with their blocks, no replication); each
step gathers its sharded outputs in block order onto the mesh's first
device.  The only collective of the JAX steps, the ``psum`` of the
compressed sizes used for order-preserving frame assembly, is a "sum"
reduction over the shards.  The block count must split evenly over the
mesh (the codecs pad it, fse_codec._pad_batch).  Inputs are numpy arrays
or tensors on any device.
"""
from __future__ import annotations

import torch

from ..ops import fse_kernels, fse_tables, huf_kernels
from ..ops.bitio import words_to_bytes
from .mesh import Mesh
from .turbo_dp import _step


def sharded_encode(mesh: Mesh, max_syms: int, out_bytes: int):
    """Returns a step: (src[B,S], n[B], norm[B,256], tlog[B]) ->
    (words[B,W], csize[B], total_csize).  B must divide over the mesh."""

    def local(src, n, norm, tlog):
        ctables = fse_tables.build_ctables(norm, tlog)
        words, csize = fse_kernels.fse_encode_batch(
            src, n, tlog, ctables, max_syms=max_syms, out_bytes=out_bytes)
        # order-preserving assembly needs the global size total
        return words, csize, csize.to(torch.int64).sum()

    return _step(mesh, local, ("sum",))


def sharded_decode(mesh: Mesh, max_out: int):
    """Returns a step: (streams[B,S], csize[B], n[B], norm[B,256], tlog[B])
    -> (out[B,max_out], err[B])."""

    def local(streams, csize, n, norm, tlog):
        dt = fse_tables.build_dtables(norm, tlog)
        return fse_kernels.fse_decode_batch(streams, csize, n, tlog, dt[:3],
                                            max_out=max_out)

    return _step(mesh, local, ())


def sharded_huf_encode(mesh: Mesh, max_syms: int, seg_bytes: int):
    """(src[B,S], n[B], val[B,256], nb[B,256]) sharded over the mesh ->
    (words[B,4,W], sizes[B,4]).  B must be a multiple of the mesh size."""

    def local(src, n, val, nb):
        return huf_kernels.huf_encode_4x_batch(src, n, val, nb, max_syms, seg_bytes)

    return _step(mesh, local, ())


def sharded_huf_decode(mesh: Mesh, max_seg: int):
    """(streams[4B,S], csize[4B], nout[4B], tlogs[4B], weights[B,256],
    tl_blocks[B]) -> (out[4B,max_seg], err[4B]).  The per-block X1 tables
    are built on each shard's device, so they shard with their streams."""

    def local(streams, csize, nout, tlogs, weights, tl_blocks):
        byte_tbl, nb_tbl = huf_kernels.build_dtables_x1(weights, tl_blocks)
        return huf_kernels.huf_decode_4x1_batch(
            streams, csize, nout, tlogs,
            (byte_tbl.repeat_interleave(4, dim=0), nb_tbl.repeat_interleave(4, dim=0)),
            max_seg=max_seg)

    def step(streams, csize, nout, tlogs, weights, tl_blocks):
        # the stream arrays hold 4 rows a block: shard them as [B, 4, ...]
        # so each shard keeps its blocks' streams
        B = len(weights)
        shaped = [torch.as_tensor(a).reshape(B, 4, *a.shape[1:])
                  for a in (streams, csize, nout, tlogs)]

        def per_block(st, cs, no, tl, w, tb):
            return local(st.flatten(0, 1), cs.flatten(), no.flatten(), tl.flatten(),
                         w, tb)
        return _step(mesh, per_block, ())(*shaped, weights, tl_blocks)

    return step


def sharded_fse_step(mesh: Mesh, block_size: int = 4096):
    """Full round-trip step (encode -> decode -> verify), sharded over the
    mesh: the multi-device dry run's step (per-block table build, 2-state
    encode, bit pack, decode, the size reduction).  (src[B,S], n[B],
    norm[B,256], tlog[B]) -> (ok, total_csize)."""
    S = block_size
    out_bytes = S + (S >> 6) + 64

    def local(src, n, norm, tlog):
        ctables = fse_tables.build_ctables(norm, tlog)
        words, csize = fse_kernels.fse_encode_batch(
            src, n, tlog, ctables, max_syms=S, out_bytes=out_bytes)
        streams = words_to_bytes(words)
        dt = fse_tables.build_dtables(norm, tlog)
        out, err = fse_kernels.fse_decode_batch(streams, csize, n, tlog, dt[:3],
                                                max_out=S)
        live = torch.arange(S, device=src.device)[None, :] < n[:, None]
        ok = (~err).all() & torch.where(live, out == src, True).all()
        return ok.to(torch.int32), csize.to(torch.int64).sum()

    return _step(mesh, local, ("min", "sum"))
