"""Data-parallel TurboRANS over a device mesh.

The port of the JAX package's parallel/turbo_dp.py.  Groups are
independent, so group arrays split over the mesh's devices.  Each
``sharded_turbo_*`` function returns a step: the step cuts the leading
group dimension of its inputs into one equal shard per device, moves each
shard to its device, and launches that shard's kernels there (kernel
launches do not wait, so the devices run side by side), then gathers the
sharded outputs onto the mesh's first device in group order.  JAX's
collectives become reductions over the shards: ``psum`` of the compressed
sizes a sum, ``pmax`` of the error flags a max, ``pmin`` of the checks a
min.  Each function passes the placement, steptots setting and mode that
its JAX original passes.  The four steps the entry points run
(sharded_turbo_encode, _encode_v2, _decode, _decode_v2) take
``interpret`` as their last parameter and pass it to the wrappers: True
runs the plain PyTorch versions of the kernels.

On a (dcn, ici) mesh across hosts (distributed.codec_mesh) each process
runs the shards of its row only and the rows' results meet over the
process group (all_gather, all_reduce), so every process returns the
whole result, as every JAX process sees the global array.

The group count must split evenly over the mesh, as shard_map requires;
the entry points pad it (api._pad_groups).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..turbo.rans_kernels import (rans_decode, rans_decode_v2, rans_decode_w,
                                  rans_encode2)
from .mesh import Mesh


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}


def _row(mesh: Mesh) -> int:
    """The mesh row this process drives: 0 on a one-level mesh; on a (dcn,
    ici) mesh the rank of this process, one process per row."""
    if mesh.devices.ndim == 1:
        return 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != mesh.devices.shape[0]:
        raise ValueError(f"a {mesh.devices.shape[0]}-row mesh needs that many "
                         f"processes, one per row; the job has {world}")
    return dist.get_rank() if world > 1 else 0


def _shards(mesh: Mesh, row: int, arrays) -> list[list[torch.Tensor]]:
    """The shards of row `row` of the mesh (every device of a one-level
    mesh): each array's groups cut into one shard per mesh device, in the
    mesh's flat order, each of this row's shards moved to its device."""
    devs = mesh.devices.reshape(-1, mesh.devices.shape[-1])[row].tolist()
    n = mesh.devices.size
    G = arrays[0].shape[0]
    if G % n:
        raise ValueError(f"{G} groups do not split over {n} devices; "
                         f"pad them to a multiple (api._pad_groups)")
    per = G // n
    first = row * len(devs)
    ts = [torch.as_tensor(a) for a in arrays]
    return [[t[(first + i) * per:(first + i + 1) * per].to(d) for t in ts]
            for i, d in enumerate(devs)]


def _step(mesh: Mesh, local, reductions: tuple[str, ...]):
    """The step of local over mesh: local(*shard) returns a tuple whose last
    len(reductions) entries reduce over the shards ("sum", "max" or "min")
    and whose other entries (tensors or None) gather in group order.  On a
    (dcn, ici) mesh each process runs its row's shards and the rows gather
    and reduce over the process group."""

    def step(*arrays):
        row = _row(mesh)
        shards = _shards(mesh, row, arrays)
        home = shards[0][0].device
        parts = [local(*shard) for shard in shards]
        n_gather = len(parts[0]) - len(reductions)
        out = []
        for i in range(n_gather):
            col = [p[i] for p in parts]
            out.append(None if col[0] is None
                       else torch.cat([c.to(home) for c in col]))
        for j, op in enumerate(reductions):
            vals = torch.stack([p[n_gather + j].to(home) for p in parts])
            out.append(getattr(vals, op)())
        if mesh.devices.ndim == 1 or mesh.devices.shape[0] == 1:
            return tuple(out)
        for i in range(n_gather):
            if out[i] is not None:
                rows = [torch.empty_like(out[i])
                        for _ in range(mesh.devices.shape[0])]
                dist.all_gather(rows, out[i].contiguous())
                out[i] = torch.cat(rows)
        for j, op in enumerate(reductions):
            v = out[n_gather + j].reshape(1)
            dist.all_reduce(v, _REDUCE_OPS[op])
            out[n_gather + j] = v[0]
        return tuple(out)

    return step


def _ok(out, want, err) -> torch.Tensor:
    return ((out == want).all() & (err == 0).all()).to(torch.int32)


def sharded_turbo_encode(mesh: Mesh, t4_count: int, hrows_cap: int,
                         tlog: int = 11, force_chunk: int = 0,
                         interpret: bool = False):
    """(fc[G,2,128], mg[G,2,128], srcw[G,t4*8,128]) -> (stream, final_states,
    csize_hw gathered; total_hw summed): the ratio-mode encode (flat
    placement, no step counts), whose frames equal the single-device
    path's."""

    def local(fc, mg, srcw):
        stream, fin, csize, _ = rans_encode2(fc, mg, srcw, t4_count, hrows_cap,
                                             tlog, steptots=False,
                                             force_chunk=force_chunk,
                                             interpret=interpret)
        return stream, fin, csize, csize.sum()

    return _step(mesh, local, ("sum",))


def sharded_turbo_decode(mesh: Mesh, t4_count: int, hrows: int,
                         tlog: int = 11, u16: bool = False, pair: bool = False,
                         interpret: bool = False):
    """(csize[G], tbl, init[G,8,128], hws[G,srows,128] packed payload words)
    -> (out, err gathered; any_err the max over the shards): the v1
    decode."""

    def local(cs, tbl, init, hws):
        out, err = rans_decode(cs, tbl, init, hws, t4_count, hrows, u16=u16,
                               tlog=tlog, pair=pair, interpret=interpret)
        return out, err, err.abs().max()

    return _step(mesh, local, ("max",))


def sharded_turbo_encode_v2(mesh: Mesh, t4_count: int, hrows_cap: int,
                            tlog: int = 11, force_chunk: int = 0,
                            u16: bool = False, rowloc: bool = False,
                            quad: bool = False, interpret: bool = False):
    """Speed-mode encode (FLAG_STEPTOTS wire): (fc, mg, srcw) -> (stream,
    final_states, csize_hw, steptots gathered; total_hw summed).  u16
    selects the 2-symbols-per-word source layout (U16 and pair wires);
    rowloc the row-local placement."""

    def local(fc, mg, srcw):
        stream, fin, csize, stots = rans_encode2(
            fc, mg, srcw, t4_count, hrows_cap, tlog, u16=u16, quad=quad,
            force_chunk=force_chunk, rowloc=rowloc, interpret=interpret)
        return stream, fin, csize, stots, csize.sum()

    return _step(mesh, local, ("sum",))


def sharded_turbo_decode_v2(mesh: Mesh, t4_count: int, hrows: int,
                            tlog: int = 11, u16: bool = False,
                            pair: bool = False, quad: bool = False,
                            interpret: bool = False):
    """Speed-mode decode (shipped steptots): (csize, tbl, init, hws,
    steptots) -> (out, err gathered; any_err the max over the shards)."""

    def local(cs, tbl, init, hws, stots):
        out, err = rans_decode_v2(cs, tbl, init, hws, stots, t4_count, hrows,
                                  tlog, u16=u16, pair=pair, quad=quad,
                                  interpret=interpret)
        return out, err, err.abs().max()

    return _step(mesh, local, ("max",))


def sharded_turbo_decode_w(mesh: Mesh, t4_count: int, hrows: int, nway: int,
                           tlog: int = 11, S: int = 32, u16: bool = False,
                           u16x: bool = False):
    """The windowed-decoder entry (rans_decode_w) over the mesh: the
    contract of sharded_turbo_decode_v2."""

    def local(cs, tbl, init, hws, stots):
        out, err = rans_decode_w(cs, tbl, init, hws, stots, t4_count, hrows,
                                 nway, tlog, S, u16=u16, u16x=u16x)
        return out, err, err.abs().max()

    return _step(mesh, local, ("max",))


def sharded_turbo_roundtrip_v2(mesh: Mesh, t4_count: int, hrows_cap: int,
                               tlog: int = 11):
    """Speed-mode round trip (flat encode with step counts -> v2 decode):
    (fc, mg, srcw, dtbl) -> (ok = 1 when every shard decodes its source
    with no error, total_hw)."""

    def local(fc, mg, srcw, dtbl):
        stream, fin, csize, stots = rans_encode2(fc, mg, srcw, t4_count,
                                                 hrows_cap, tlog)
        out, err = rans_decode_v2(csize, dtbl, fin, stream, stots, t4_count,
                                  hrows_cap, tlog)
        return _ok(out, srcw, err), csize.sum()

    return _step(mesh, local, ("min", "sum"))


def sharded_turbo_roundtrip_w(mesh: Mesh, t4_count: int, hrows_cap: int,
                              nway: int = 1, S: int = 32, tlog: int = 11):
    """Row-local encode -> windowed decode entry (rans_decode_w) round trip:
    (fc, mg, srcw, dtbl) -> (ok, total_hw)."""

    def local(fc, mg, srcw, dtbl):
        stream, fin, csize, stots = rans_encode2(fc, mg, srcw, t4_count,
                                                 hrows_cap, tlog, rowloc=True)
        out, err = rans_decode_w(csize, dtbl, fin, stream, stots, t4_count,
                                 hrows_cap, nway, tlog, S)
        return _ok(out, srcw, err), csize.sum()

    return _step(mesh, local, ("min", "sum"))


def sharded_turbo16_roundtrip(mesh: Mesh, t2_count: int, hrows_cap: int,
                              tlog: int = 11):
    """U16 speed-mode round trip (flat encode of u16 symbols <= 1023 ->
    v2 decode): (fc[G,8,128], mg, srcw, dtbl) -> (ok, total_hw)."""

    def local(fc, mg, srcw, dtbl):
        stream, fin, csize, stots = rans_encode2(fc, mg, srcw, t2_count,
                                                 hrows_cap, tlog, u16=True)
        out, err = rans_decode_v2(csize, dtbl, fin, stream, stots, t2_count,
                                  hrows_cap, tlog, u16=True)
        return _ok(out, srcw, err), csize.sum()

    return _step(mesh, local, ("min", "sum"))


def sharded_turbo_pair_roundtrip(mesh: Mesh, t2_count: int, hrows_cap: int,
                                 tlog: int = 9):
    """Pair-wire round trip (row-local encode over pair ids -> pair-mode v2
    decode): (fc, mg, srcw, dtbl) -> (out gathered: pair VALUES, which the
    caller checks; ok = no error flag; total_hw)."""

    def local(fc, mg, srcw, dtbl):
        stream, fin, csize, stots = rans_encode2(fc, mg, srcw, t2_count,
                                                 hrows_cap, tlog, u16=True,
                                                 rowloc=True)
        out, err = rans_decode_v2(csize, dtbl, fin, stream, stots, t2_count,
                                  hrows_cap, tlog, u16=True, pair=True)
        return out, (err == 0).all().to(torch.int32), csize.sum()

    return _step(mesh, local, ("min", "sum"))


def sharded_turbo_quad_roundtrip(mesh: Mesh, steps: int, hrows_cap: int,
                                 tlog: int = 11):
    """Quad-wire round trip (row-local spc=1 encode over quad ids -> quad-
    mode v2 decode): (fc, mg, srcw, dtbl) -> (out gathered: quad values;
    ok; total_hw)."""

    def local(fc, mg, srcw, dtbl):
        stream, fin, csize, stots = rans_encode2(fc, mg, srcw, steps,
                                                 hrows_cap, tlog, quad=True,
                                                 rowloc=True)
        out, err = rans_decode_v2(csize, dtbl, fin, stream, stots, steps,
                                  hrows_cap, tlog, quad=True)
        return out, (err == 0).all().to(torch.int32), csize.sum()

    return _step(mesh, local, ("min", "sum"))


def sharded_turbo_roundtrip(mesh: Mesh, t4_count: int, hrows_cap: int):
    """Ratio-mode round trip (flat encode at tableLog 11, no step counts ->
    v1 decode): (fc, mg, srcw, dtbl) -> (ok, total_hw)."""

    def local(fc, mg, srcw, dtbl):
        stream, fin, csize, _ = rans_encode2(fc, mg, srcw, t4_count,
                                             hrows_cap, 11, steptots=False)
        out, err = rans_decode(csize, dtbl, fin, stream, t4_count, hrows_cap)
        return _ok(out, srcw, err), csize.sum()

    return _step(mesh, local, ("min", "sum"))
