"""The port's multi-device layer (parallel/) on CPU meshes.

A CPU mesh holds n entries of torch.device("cpu"), the counterpart of the
8 virtual CPU devices tests/conftest.py gives JAX; its shards run the
plain PyTorch versions one after another.  Frames written with mesh=m
must equal the single-device frames, the numpy twins and, on the
cross-check input, the JAX package's mesh=2 frames; every sharded step
must agree with the single-device wrappers.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from finitestateentropy_tpu_torch.parallel import turbo_dp
from finitestateentropy_tpu_torch.parallel.mesh import (CPU_DEVICES, Mesh,
                                                        device_count, get_mesh,
                                                        make_mesh,
                                                        make_mesh_2level)
from finitestateentropy_tpu_torch.turbo import rans_kernels as rk
from finitestateentropy_tpu_torch.turbo.api import (STAGE_BATCH, _hrows_cap,
                                                    _pad_groups, _wire_t4,
                                                    mode_flags, parse_groups,
                                                    plan_decode, plan_encode,
                                                    stage_decode_batch,
                                                    turbo_compress_device,
                                                    turbo_decompress_device)
from finitestateentropy_tpu_torch.turbo.pair import pair_compress
from finitestateentropy_tpu_torch.turbo.quad import quad_compress
from finitestateentropy_tpu_torch.turbo.rans import (parse_rans_group,
                                                     rans_compress,
                                                     rans_decompress)
from finitestateentropy_tpu_torch.utils import generate_proba

REPO = Path(__file__).resolve().parent.parent
MODES = {"speed": dict(pair=0, quad=0), "ratio": dict(steptots=False),
         "totals": dict(totals_only=True), "default": {}}


def _inputs():
    """The mixed 9000-byte input (RLE, raw, odd-T quad and small groups)
    and 3*8192+777 bytes of Proba80 (tests/test_mesh_paths.py:53)."""
    rng = np.random.default_rng(5)
    mixed = (generate_proba(80)[:20000] + b"R" * 9000
             + bytes(rng.integers(0, 256, 12000, dtype=np.uint8))
             + generate_proba(14)[:5000])
    return {"mixed_9000": (mixed, 9000),
            "p80_3x8192": (generate_proba(80)[: 3 * 8192 + 777], 8192)}


def _check_twins(blob: bytes, data: bytes, group: int, kw: dict) -> None:
    """Each frame of blob equals the numpy twin's frame of its group, on the
    wire the entry point picks.  Where the twin shrinks a small group's
    tableLog (FSE_optimalTableLog) and the entry point, as the JAX
    package's, renormalizes at the mode's tableLog, the twin's decoder
    reads the frame instead."""
    steptots = kw.get("steptots", True)
    tlog, pair, quad = mode_flags(0, steptots, kw.get("totals_only", False),
                                  kw.get("pair", -1), kw.get("quad", -1))
    _n, _f, batches = plan_encode(data, group, tlog, pair, quad)
    wire_of = {gi: w for (w, _p, _t), items in batches.items()
               for gi, _ch, _prep in items}
    pos = 0
    for gi in range(-(-len(data) // group)):
        ch = data[gi * group:(gi + 1) * group]
        g, used = parse_rans_group(blob[pos:])
        frame = blob[pos:pos + used]
        pos += used
        wire = wire_of.get(gi, "byte")
        twin = (quad_compress(ch) if wire == "quad"
                else pair_compress(ch, steptots=steptots) if wire == "pair"
                else None)
        if twin is None:
            twin = rans_compress(ch, steptots=steptots,
                                 totals_only=kw.get("totals_only", False))
        if parse_rans_group(twin)[0][2] == g[2]:
            assert frame == twin, (gi, wire)
        else:
            assert wire == "byte" and rans_decompress(frame) == ch
    assert pos == len(blob)


@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", ["mixed_9000", "p80_3x8192"])
def test_mesh_frames_equal_single_device_and_twins(name, mode, m):
    data, group = _inputs()[name]
    kw = MODES[mode]
    one = turbo_compress_device(data, group, device="cpu", **kw)
    meshed = turbo_compress_device(data, group, mesh=m, device="cpu", **kw)
    assert meshed == one
    _check_twins(meshed, data, group, kw)
    assert turbo_decompress_device(meshed, mesh=m, device="cpu") == data


@pytest.mark.parametrize("mode", ["speed", "ratio"])
def test_mesh_frames_equal_jax_mesh_interpret(mode):
    """The JAX package's mesh=2 frames (the flat encode under shard_map, in
    interpret mode on two virtual CPU devices) equal the port's."""
    from finitestateentropy_tpu.turbo.api import \
        turbo_compress_device as j_compress

    data, group = _inputs()["p80_3x8192"]
    want = j_compress(data, group_size=group, interpret=True, mesh=2,
                      **MODES[mode])
    assert turbo_compress_device(data, group, mesh=2, device="cpu",
                                 **MODES[mode]) == want
    assert turbo_decompress_device(want, mesh=2, device="cpu") == data


def test_get_mesh_warns_and_falls_back():
    with pytest.warns(UserWarning, match="single-device"):
        assert get_mesh(CPU_DEVICES + 1, "cpu") is None
    assert get_mesh(1, "cpu") is None
    mesh = get_mesh(4, "cpu")
    assert mesh.devices.size == 4 and mesh.axis_names == ("dp",)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert make_mesh_2level(2, 3, "cpu").devices.shape == (2, 3)
    data, group = _inputs()["p80_3x8192"]
    with pytest.warns(UserWarning, match="single-device"):
        blob = turbo_compress_device(data, group, mesh=64, device="cpu")
    assert blob == turbo_compress_device(data, group, device="cpu")
    if not torch.cuda.is_available():      # the default mesh is the CUDA devices
        assert device_count() == 0 and make_mesh().devices.size == 0
        with pytest.warns(UserWarning, match="only 0 device"):
            assert get_mesh(2) is None


def _encode_inputs(data: bytes, group: int, wire: str, **flags):
    """The entry point's first encode batch of a wire: (fc, mg, srcw, t4,
    hcap, tlog)."""
    _n, _f, batches = plan_encode(data, group, 10, **flags)
    (w, n_pad, tlog), items = next((k, v) for k, v in batches.items()
                                   if k[0] == wire)
    fc, mg, srcw = STAGE_BATCH[w](items, n_pad)
    return fc, mg, srcw, _wire_t4(w, n_pad), _hrows_cap(n_pad), tlog


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _equal(got, want, G: int) -> None:
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g[:G], w)


@pytest.mark.parametrize("m", [2, 4, 8])
def test_sharded_steps_match_single_device(m):
    """Each sharded step against the single-device wrappers on 5 groups,
    padded to a multiple of m as the entry points pad them; the summed
    and maxed values equal those over the padded batch."""
    mesh = make_mesh(m, device="cpu")
    data = generate_proba(80, 5 * 40960)
    for wire, flags, steps in (
            ("byte", dict(pair=0, quad=0), (
                (turbo_dp.sharded_turbo_encode, {}, dict(steptots=False)),
                (turbo_dp.sharded_turbo_encode_v2, {}, {}))),
            ("pair", dict(quad=0), (
                (turbo_dp.sharded_turbo_encode_v2, dict(u16=True, rowloc=True),
                 dict(u16=True, rowloc=True)),)),
            ("quad", dict(quad=1), (
                (turbo_dp.sharded_turbo_encode_v2, dict(quad=True, rowloc=True),
                 dict(quad=True, rowloc=True)),))):
        fc, mg, srcw, t4, hcap, tlog = _encode_inputs(data, 40960, wire, **flags)
        G = fc.shape[0]
        assert G == 5
        padded = _pad_groups([fc, mg, srcw], m)
        for make, step_kw, single_kw in steps:
            got = make(mesh, t4, hcap, tlog, **step_kw)(*padded)
            want = rk.rans_encode2(_t(fc), _t(mg), _t(srcw), t4, hcap, tlog,
                                   **single_kw)
            _equal(got[:-1], want, G)
            assert int(got[-1]) == int(rk.rans_encode2(
                *(_t(a) for a in padded), t4, hcap, tlog, **single_kw)[2].sum())
    data = generate_proba(80, 5 * 131072)     # decode_w: t4 a multiple of 32
    for kind, make in ((2, turbo_dp.sharded_turbo_decode_v2),
                       (1, turbo_dp.sharded_turbo_decode_v2),
                       (2, turbo_dp.sharded_turbo_decode_w),
                       (0, turbo_dp.sharded_turbo_decode)):
        groups = parse_groups(turbo_compress_device(
            data, 131072, device="cpu", steptots=kind != 0,
            totals_only=kind == 1, pair=0, quad=0))
        ((wire, n_pad, tlog, k), idxs), = plan_decode(groups)[1].items()
        assert k == kind
        cs, tbl, init, hws, tots, t4, hrows = stage_decode_batch(
            groups, idxs, n_pad, tlog, wire, kind)
        hws[3, 2, 7] ^= 1 << 9                   # corrupt group 3
        arrays = [cs, tbl, init, hws] + ([tots] if kind else [])
        if make is turbo_dp.sharded_turbo_decode_w:
            step = make(mesh, t4, hrows, 8, tlog, 32)
            want = rk.rans_decode_w(*(_t(a) for a in arrays), t4, hrows, 8,
                                    tlog, 32)
        elif kind:
            step = make(mesh, t4, hrows, tlog)
            want = rk.rans_decode_v2(*(_t(a) for a in arrays), t4, hrows, tlog)
        else:
            step = make(mesh, t4, hrows, tlog)
            want = rk.rans_decode(*(_t(a) for a in arrays), t4, hrows, tlog=tlog)
        out, err, any_err = step(*_pad_groups(arrays, m))
        _equal((out, err), want, 5)
        assert err[:5].tolist() == [0, 0, 0, 1, 0] and int(any_err) == 1


@pytest.mark.parametrize("m", [2, 4, 8])
def test_sharded_roundtrips_match_single_device(m):
    """The ratio and speed round trips (flat encode) on 5 padded groups:
    ok, and the summed halfwords of the single-device encode; the windowed
    round trip on 2 groups of 128 KiB."""
    from finitestateentropy_tpu_torch.parallel.dryrun import byte_inputs

    mesh = make_mesh(m, device="cpu")
    for G, gsz, make, single in (
            (5, 8192, turbo_dp.sharded_turbo_roundtrip, dict(steptots=False)),
            (5, 8192, turbo_dp.sharded_turbo_roundtrip_v2, {}),
            (2, 131072, turbo_dp.sharded_turbo_roundtrip_w, dict(rowloc=True))):
        fc, mg, srcw, dtbl, t4, hcap = byte_inputs(generate_proba(80), G, gsz)
        padded = _pad_groups([fc, mg, srcw, dtbl], m)
        ok, total = make(mesh, t4, hcap)(*padded)
        csize = rk.rans_encode2(*(_t(a) for a in padded[:3]), t4, hcap, 11,
                                **single)[2]
        assert int(ok) == 1 and int(total) == int(csize.sum())
        bad = [a.copy() for a in padded]
        bad[3][-1, 0, 5] ^= 1 << 10            # a wrong decode table entry
        assert int(make(mesh, t4, hcap)(*bad)[0]) == 0


def test_sharded_steps_need_an_even_split():
    mesh = make_mesh(4, device="cpu")
    fc, mg, srcw, t4, hcap, tlog = _encode_inputs(
        generate_proba(80, 5 * 40960), 40960, "byte", pair=0, quad=0)
    with pytest.raises(ValueError, match="do not split"):
        turbo_dp.sharded_turbo_encode(mesh, t4, hcap, tlog)(fc, mg, srcw)


def test_dryrun_multichip_on_a_cpu_mesh():
    from finitestateentropy_tpu_torch.parallel.dryrun import dryrun_multichip

    lines = []
    dryrun_multichip(CPU_DEVICES, "cpu", lines.append)
    assert len(lines) == 7 and all(" ok" in ln for ln in lines)
    # the totals of the JAX package's 8-device dry run (MULTICHIP_r05.json)
    for what, total in (("turbo ok", 475), ("turbo u16 ok", 21414),
                        ("turbo pair wire ok", 338), ("turbo quad wire ok", 5678)):
        assert any(f"{what}, total = {total} " in ln for ln in lines), what


def test_submesh_keeps_axis():
    mesh = make_mesh(4, device="cpu")
    sub = Mesh(mesh.devices[:2], ("dp",))
    assert sub.devices.size == 2


_MULTIHOST = r"""
import socket, sys
sys.modules["jax"] = None
sys.modules["finitestateentropy_tpu"] = None
import numpy as np
import torch.distributed as dist
from finitestateentropy_tpu_torch.parallel.distributed import (
    codec_mesh, initialize_multihost, shard_ranges)
from finitestateentropy_tpu_torch.parallel.dryrun import byte_inputs
from finitestateentropy_tpu_torch.parallel.turbo_dp import sharded_turbo_roundtrip
from finitestateentropy_tpu_torch.utils import generate_proba
with socket.socket() as s:
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
initialize_multihost(f"localhost:{port}", 1, 0)
assert dist.is_initialized() and dist.get_world_size() == 1
mesh = codec_mesh("cpu")
assert mesh.axis_names == ("dp",) and mesh.devices.size == 8
assert shard_ranges(10) == [(0, 10)]
fc, mg, srcw, dtbl, t4, hcap = byte_inputs(generate_proba(80), 8, 8192)
ok, total = sharded_turbo_roundtrip(mesh, t4, hcap)(fc, mg, srcw, dtbl)
assert int(ok) == 1 and int(total) > 0
dist.destroy_process_group()
print("ok")
"""


def test_multihost_single_process():
    """initialize_multihost on a free localhost port with one process (gloo
    without CUDA), then codec_mesh, shard_ranges and a sharded round trip,
    with jax and the JAX package blocked."""
    r = subprocess.run([sys.executable, "-c", _MULTIHOST], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


_TWO_HOSTS = r"""
import sys
sys.modules["jax"] = None
sys.modules["finitestateentropy_tpu"] = None
import torch
import torch.distributed as dist
from finitestateentropy_tpu_torch.parallel import turbo_dp
from finitestateentropy_tpu_torch.parallel.distributed import (
    codec_mesh, initialize_multihost, shard_ranges)
from finitestateentropy_tpu_torch.parallel.dryrun import byte_inputs
from finitestateentropy_tpu_torch.turbo.api import (turbo_compress_device,
                                                    turbo_decompress_device)
from finitestateentropy_tpu_torch.utils import generate_proba
port, rank = int(sys.argv[1]), int(sys.argv[2])
initialize_multihost(f"localhost:{port}", 2, rank)
mesh = codec_mesh("cpu")
assert mesh.axis_names == ("dcn", "ici") and mesh.devices.shape == (2, 8)
assert shard_ranges(10) == [(0, 5), (5, 10)]
seen = []
encode = turbo_dp.rans_encode2
def counted(fc, *a, **k):
    seen.append(fc.shape[0])
    return encode(fc, *a, **k)
turbo_dp.rans_encode2 = counted
fc, mg, srcw, dtbl, t4, hcap = byte_inputs(generate_proba(80), 16, 8192)
ok, total = turbo_dp.sharded_turbo_roundtrip(mesh, t4, hcap)(fc, mg, srcw, dtbl)
want = encode(*(torch.from_numpy(a) for a in (fc, mg, srcw)), t4, hcap, 11,
              steptots=False)[2]
assert int(ok) == 1 and int(total) == int(want.sum())
assert seen == [1] * 8, seen      # this process encoded its row's 8 groups
bad = dtbl.copy()
bad[15] ^= 1 << 10                # a wrong table in the last row's shard
assert int(turbo_dp.sharded_turbo_roundtrip(mesh, t4, hcap)(
    fc, mg, srcw, bad)[0]) == 0
data = generate_proba(80)[: 3 * 8192 + 777]
for kw in (dict(pair=0, quad=0), dict(steptots=False), {}):
    blob = turbo_compress_device(data, 8192, mesh=mesh, device="cpu", **kw)
    assert blob == turbo_compress_device(data, 8192, device="cpu", **kw), kw
    assert turbo_decompress_device(blob, mesh=mesh, device="cpu") == data
dist.destroy_process_group()
print("ok")
"""


def test_multihost_two_processes():
    """Two processes (gloo) on a (dcn, ici) mesh of 2 x 8 CPU entries: each
    runs only its row's shards, and both get the whole result: the round
    trip's ok (a bad table in the other row reaches both), its summed
    size, and entry-point frames equal to the single-device ones."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_HOSTS, str(port),
                               str(rank)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for rank in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip().endswith("ok")
