"""The multi-device dry run: every sharded codec step over a mesh.

The port of the JAX package's ``__graft_entry__.dryrun_multichip``: its
compat step (``parallel/dp.py:sharded_fse_step`` on two 1 KiB blocks a
device: table build, encode, decode and verify, with the size reduction),
then the turbo half (``_turbo_dryrun`` and the dry runs it calls): the
ratio and speed round trips (flat encode placement), the row-local encode
with the windowed-decoder entry, the U16 wire, the pair and quad wires,
and a mixed RLE / raw / coded buffer through the entry points with
``mesh`` set, whose frames must equal the single-device ones.  Shapes are
small: groups of 8-128 KiB, two per device.

    python -m finitestateentropy_tpu_torch.parallel.dryrun [n_devices] [cpu]
"""
from __future__ import annotations

import sys

import numpy as np

from ..refimpl.norm import fse_normalize_count, fse_optimal_table_log
from ..turbo.api import (_hrows_cap, _prep_group, turbo_compress_device,
                         turbo_decompress_device)
from ..turbo.format import TURBO_STEP_SYMS, _pad_n
from ..turbo.pair import prep_pair_group
from ..turbo.quad import _pad_q, prep_quad_group
from ..turbo.rans16 import _pad_n16
from ..turbo.tables import (pack_pair_dtable, pack_quad_dtable,
                            pack_rans16_ctables, pack_rans16_dtable,
                            pack_rans_ctables, pack_rans_dtable)
from ..utils import generate_proba
from .dp import sharded_fse_step
from .mesh import Mesh, device_count, make_mesh
from .turbo_dp import (sharded_turbo16_roundtrip, sharded_turbo_pair_roundtrip,
                       sharded_turbo_quad_roundtrip, sharded_turbo_roundtrip,
                       sharded_turbo_roundtrip_v2, sharded_turbo_roundtrip_w)


COMPAT_BLOCK = 1024


def compat_inputs(n_blocks: int, block_size: int = COMPAT_BLOCK):
    """(src[B,S], n[B], norm[B,256], tlog[B]) of the graft entry's example
    batch (__graft_entry__._example_batch): blocks of 16 symbols drawn from
    a dirichlet(0.4) distribution each, their normalized counts."""
    rng = np.random.default_rng(0)
    src = np.zeros((n_blocks, block_size), dtype=np.uint8)
    norms = np.zeros((n_blocks, 256), dtype=np.int32)
    tlogs = np.zeros(n_blocks, dtype=np.int32)
    ns = np.full(n_blocks, block_size, dtype=np.int32)
    for b in range(n_blocks):
        probs = rng.dirichlet(np.full(16, 0.4))
        blk = rng.choice(16, size=block_size, p=probs).astype(np.uint8)
        src[b] = blk
        count = np.bincount(blk, minlength=256)
        max_sv = int(blk.max())
        tlog = fse_optimal_table_log(11, block_size, max_sv)
        norm, tlog = fse_normalize_count(tlog, count[: max_sv + 1], block_size, max_sv)
        norms[b, : len(norm)] = norm
        tlogs[b] = tlog
    return src, ns, norms, tlogs


def _compat_dryrun(mesh: Mesh, n: int, log) -> None:
    """The graft entry's compat step: sharded_fse_step on two blocks a
    device."""
    ok, total = sharded_fse_step(mesh, block_size=COMPAT_BLOCK)(
        *compat_inputs(2 * n))
    assert int(ok) == 1, "multi-device FSE round-trip failed verification"
    log(f"dryrun_multichip({n}): compat ok, total = {int(total)} bytes")


def byte_inputs(data: bytes, G: int, gsz: int):
    """(fc, mg, srcw, dtbl, t4, hcap) of G byte groups of gsz bytes at
    tableLog 11."""
    n_pad = _pad_n(gsz)
    t4 = n_pad // TURBO_STEP_SYMS
    fc = np.zeros((G, 2, 128), np.int32)
    mg = np.zeros((G, 2, 128), np.int32)
    dtbl = np.zeros((G, 16, 128), np.int32)
    srcw = np.zeros((G, t4 * 8, 128), np.int32)
    for g in range(G):
        chunk = np.frombuffer(data[g * gsz:(g + 1) * gsz], np.uint8)
        norm, _max_sv, _nc, mfs = _prep_group(chunk)
        fc[g], mg[g] = pack_rans_ctables(norm)
        dtbl[g] = pack_rans_dtable(norm)
        pad = np.full(n_pad, mfs, np.uint8)
        pad[:gsz] = chunk
        srcw[g] = pad.view("<u4").view(np.int32).reshape(t4 * 8, 128)
    return fc, mg, srcw, dtbl, t4, _hrows_cap(n_pad)


def _repeat(base: bytes, n: int) -> bytes:
    return (base * (n // len(base) + 1))[:n]


def _turbo_dryrun(mesh: Mesh, n: int, log) -> None:
    fc, mg, srcw, dtbl, t4, hcap = byte_inputs(generate_proba(80), 2 * n, 8192)
    ok, total = sharded_turbo_roundtrip(mesh, t4, hcap)(fc, mg, srcw, dtbl)
    assert int(ok) == 1, "multi-device turbo round-trip failed verification"
    log(f"dryrun_multichip({n}): turbo ok, total = {int(total)} halfwords")
    ok, total = sharded_turbo_roundtrip_v2(mesh, t4, hcap)(fc, mg, srcw, dtbl)
    assert int(ok) == 1, "multi-device turbo v2 round-trip failed verification"
    log(f"dryrun_multichip({n}): turbo v2 (speed mode) ok, "
        f"total = {int(total)} halfwords")


def w_inputs(G: int):
    """The windowed round trip's inputs: G byte groups of 128 KiB (t4 =
    32, a multiple of the window span)."""
    gsz = 128 << 10
    return byte_inputs(_repeat(generate_proba(80), G * gsz), G, gsz)


def _turbo_w_dryrun(mesh: Mesh, n: int, log) -> None:
    """Row-local encode + windowed-decoder entry, one group per device on
    at most 2."""
    G = min(n, 2)
    sub = Mesh(mesh.devices[:G], ("dp",))
    fc, mg, srcw, dtbl, t4, hcap = w_inputs(G)
    ok, total = sharded_turbo_roundtrip_w(sub, t4, hcap, 1, 32)(fc, mg, srcw, dtbl)
    assert int(ok) == 1, "multi-device windowed+rowloc round-trip failed"
    log(f"dryrun_multichip({n}): turbo windowed decode + rowloc encode ok, "
        f"total = {int(total)} halfwords")


def u16_inputs(G: int):
    """(fc, mg, srcw, dtbl, t2, hcap) of G groups of 4096 u16 symbols <=
    1023 (pareto(1.2)) at tableLog 11."""
    rng = np.random.default_rng(5)
    nsym = 4096
    n_pad = _pad_n16(nsym)
    t2 = n_pad // 2048
    hcap = (n_pad // 128 + 16 + 7) // 8 * 8
    fc = np.zeros((G, 8, 128), np.int32)
    mg = np.zeros((G, 8, 128), np.int32)
    dtbl = np.zeros((G, 16, 128), np.int32)
    srcw = np.zeros((G, t2 * 8, 128), np.int32)
    for g in range(G):
        d = np.clip((rng.pareto(1.2, nsym) * 50).astype(np.int64),
                    0, 1023).astype(np.uint16)
        count = np.bincount(d, minlength=1024)
        max_sv = int(d.max())
        norm, _tl = fse_normalize_count(11, count[: max_sv + 1], nsym, max_sv)
        fc[g], mg[g] = pack_rans16_ctables(norm)
        dtbl[g] = pack_rans16_dtable(norm, 11)
        pad = np.full(n_pad, int(count.argmax()), np.uint16)
        pad[:nsym] = d
        srcw[g] = pad.view("<u4").view(np.int32).reshape(t2 * 8, 128)
    return fc, mg, srcw, dtbl, t2, hcap


def _turbo16_dryrun(mesh: Mesh, n: int, log) -> None:
    fc, mg, srcw, dtbl, t2, hcap = u16_inputs(2 * n)
    ok, total = sharded_turbo16_roundtrip(mesh, t2, hcap)(fc, mg, srcw, dtbl)
    assert int(ok) == 1, "multi-device u16 round-trip failed verification"
    log(f"dryrun_multichip({n}): turbo u16 ok, total = {int(total)} halfwords")


def multibyte_inputs(G: int, wire: str):
    """(fc, mg, srcw, dtbl, steps, hcap, tlog, vals) of G Proba80 groups on
    the pair (8 KiB groups) or quad (16 KiB groups) wire; vals[G, n_pad]
    the values the decode must give back."""
    quad = wire == "quad"
    gsz = 16384 if quad else 8192
    data = _repeat(generate_proba(80), G * gsz)
    n_pad = _pad_q(gsz // 4) if quad else _pad_n16(gsz // 2)
    steps = n_pad // (1024 if quad else 2048)
    hcap = (n_pad // 128 + 16 + 7) // 8 * 8
    dtype = np.uint32 if quad else np.uint16
    fc = np.zeros((G, 2, 128), np.int32)
    mg = np.zeros((G, 2, 128), np.int32)
    srcw = np.zeros((G, steps * 8, 128), np.int32)
    vals = np.zeros((G, n_pad), dtype)
    tbls, tlog = [], 0
    for g in range(G):
        chunk = data[g * gsz:(g + 1) * gsz]
        p = prep_quad_group(chunk) if quad else prep_pair_group(chunk)
        assert p is not None, f"p80 slice must be {wire}-eligible"
        tlog = p["tlog"]
        fc[g], mg[g] = pack_rans_ctables(p["norm"])
        lut = p["quads" if quad else "pairs"]
        tbls.append((pack_quad_dtable if quad else pack_pair_dtable)(
            p["norm"], lut, tlog))
        pad = np.full(n_pad, p["mfi"], dtype)
        pad[: len(p["ids"])] = p["ids"]
        srcw[g] = pad.astype("<u4" if quad else "<u2").view(np.int32).reshape(
            steps * 8, 128)
        vals[g] = lut[pad]
    return fc, mg, srcw, np.stack(tbls), steps, hcap, tlog, vals


def _multibyte_dryrun(mesh: Mesh, n: int, wire: str, log) -> None:
    """The pair or quad wire: row-local encode over ids -> v2 decode; the
    decoded values are checked here."""
    quad = wire == "quad"
    G = 2 * n
    fc, mg, srcw, dtbl, steps, hcap, tlog, vals = multibyte_inputs(G, wire)
    step = (sharded_turbo_quad_roundtrip if quad else sharded_turbo_pair_roundtrip)(
        mesh, steps, hcap, tlog=tlog)
    out, ok, total = step(fc, mg, srcw, dtbl)
    assert int(ok) == 1, f"multi-device {wire} round-trip flagged errors"
    got = out.cpu().numpy().astype("<i4").reshape(G, -1).view(vals.dtype)
    for g in range(G):
        assert np.array_equal(got[g][:vals.shape[1]], vals[g]), \
            f"{wire} group {g} mismatch"
    log(f"dryrun_multichip({n}): turbo {wire} wire ok, total = {int(total)} halfwords")


MIXED_GROUP = 16384


def mixed_frame_data() -> bytes:
    """Two coded Proba80 groups around a raw and an RLE one."""
    rng = np.random.default_rng(6)
    sect = MIXED_GROUP
    base = generate_proba(80)
    return (base[:sect]                                          # coded
            + bytes(rng.integers(0, 256, sect, dtype=np.uint8))  # raw
            + b"A" * sect                                        # RLE
            + base[sect:2 * sect])                               # coded


def _mixed_frame_dryrun(n: int, device, log) -> None:
    mdata = mixed_frame_data()
    blob_mesh = turbo_compress_device(mdata, MIXED_GROUP, mesh=n, device=device)
    blob_one = turbo_compress_device(mdata, MIXED_GROUP, device=device)
    assert blob_mesh == blob_one, "mesh frame diverged from single-device"
    out = turbo_decompress_device(blob_mesh, mesh=n, device=device)
    assert out == mdata, "mixed mesh frame failed round-trip"
    log(f"dryrun_multichip({n}): mixed RLE/raw/coded frame ok "
        f"({len(mdata)} -> {len(blob_mesh)} bytes, mesh == single-device)")


def dryrun_multichip(n_devices: int, device=None, log=print) -> None:
    """Every sharded codec step on a mesh of n_devices devices (device:
    None for the CUDA devices, "cpu" for a CPU mesh); raises
    AssertionError when a round trip fails."""
    avail = device_count(device)
    assert avail >= n_devices, f"need {n_devices} devices, have {avail}"
    mesh = make_mesh(n_devices, device=device)
    _compat_dryrun(mesh, n_devices, log)
    _turbo_dryrun(mesh, n_devices, log)
    _turbo_w_dryrun(mesh, n_devices, log)
    _turbo16_dryrun(mesh, n_devices, log)
    _multibyte_dryrun(mesh, n_devices, "pair", log)
    _multibyte_dryrun(mesh, n_devices, "quad", log)
    _mixed_frame_dryrun(n_devices, device, log)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 1,
                     sys.argv[2] if len(sys.argv) > 2 else None)
