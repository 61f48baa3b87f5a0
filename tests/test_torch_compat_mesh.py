"""The compat codecs' sharded steps (parallel/dp.py) over the CPU mesh.

Each sharded_* step's outputs equal the single-device outputs and the JAX
package's parallel/dp.py on JAX's virtual CPU mesh (tests/conftest.py
gives it 8 devices), on the same numpy inputs; sharded_fse_step returns
ok with JAX's total; the codecs over a mesh write the single-device
frames (padding by repeating row 0, four stream rows a dummy block on the
Huff0 decode); the dry run's compat step passes.  Blocks are 2 KiB.
Tolerance: exact.
"""
import numpy as np
import pytest
import torch

from finitestateentropy_tpu_torch.io import frame as fio
from finitestateentropy_tpu_torch.models import FseTpuCodec, HufTpuCodec
from finitestateentropy_tpu_torch.ops import fse_kernels, fse_tables, huf_kernels
from finitestateentropy_tpu_torch.parallel import dp
from finitestateentropy_tpu_torch.parallel.dryrun import _compat_dryrun, compat_inputs
from finitestateentropy_tpu_torch.parallel.mesh import make_mesh
from finitestateentropy_tpu_torch.refimpl.hist import hist_count
from finitestateentropy_tpu_torch.refimpl.huf import (huf_build_ctable,
                                                      huf_read_stats,
                                                      huf_write_ctable)
from finitestateentropy_tpu_torch.refimpl.norm import fse_optimal_table_log
from finitestateentropy_tpu_torch.utils import generate_proba

S = 2048
OUT_BYTES = S + 64
SEG_BYTES = S // 4 + 64
M = 2                           # the mesh the JAX steps are held against


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _jax_mesh(m):
    from finitestateentropy_tpu.parallel.mesh import make_mesh as j_make_mesh

    return j_make_mesh(m)


@pytest.fixture(scope="module")
def fse_inputs():
    """4 blocks of the dry run's dirichlet corpus at 2 KiB."""
    return compat_inputs(4, S)


@pytest.fixture(scope="module")
def huf_inputs():
    blocks = [generate_proba(p)[:S] for p in (80, 14, 50, 90)]
    src = np.zeros((4, S), np.uint8)
    ns = np.full(4, S, np.int32)
    val = np.zeros((4, 256), np.int32)
    nb = np.zeros((4, 256), np.int32)
    weights = np.zeros((4, 256), np.int32)
    tls = np.zeros(4, np.int32)
    for k, b in enumerate(blocks):
        count, max_sv, _ = hist_count(b)
        tlog = fse_optimal_table_log(11, S, max_sv, minus=1, max_allowed=12)
        table = huf_build_ctable(count, max_sv, tlog)
        w, _rs, _n, tls[k], _u = huf_read_stats(huf_write_ctable(table, max_sv))
        weights[k, : len(w)] = np.frombuffer(w, np.uint8)
        src[k] = np.frombuffer(b, np.uint8)
        val[k, : max_sv + 1] = table.val
        nb[k, : max_sv + 1] = table.nb_bits
    return src, ns, val, nb, weights, tls


@pytest.mark.parametrize("m", [1, 2, 4])
def test_sharded_fse_encode_decode_equal_single_device(fse_inputs, m):
    src, ns, norms, tlogs = fse_inputs
    mesh = make_mesh(m, device="cpu")
    words, csize, total = dp.sharded_encode(mesh, S, OUT_BYTES)(src, ns, norms, tlogs)
    ct = fse_tables.build_ctables(torch.from_numpy(norms), torch.from_numpy(tlogs))
    w1, c1 = fse_kernels.fse_encode_batch(torch.from_numpy(src), torch.from_numpy(ns),
                                          torch.from_numpy(tlogs), ct, max_syms=S,
                                          out_bytes=OUT_BYTES)
    assert torch.equal(words, w1) and torch.equal(csize, c1)
    assert int(total) == int(c1.sum())
    streams = np.zeros((4, OUT_BYTES + 96), np.uint8)
    raw = _np(w1).view(np.uint8).reshape(4, -1)
    for k, c in enumerate(_np(c1)):
        streams[k, :c] = raw[k, :c]
    out, err = dp.sharded_decode(mesh, S)(streams, _np(c1), ns, norms, tlogs)
    assert not err.any() and np.array_equal(_np(out), src)


def test_sharded_fse_steps_equal_jax_dp(fse_inputs):
    import jax.numpy as jnp

    from finitestateentropy_tpu.parallel import dp as j_dp

    src, ns, norms, tlogs = fse_inputs
    jm, mesh = _jax_mesh(M), make_mesh(M, device="cpu")
    jw, jc, jt = j_dp.sharded_encode(jm, S, OUT_BYTES)(
        jnp.asarray(src), jnp.asarray(ns), jnp.asarray(norms), jnp.asarray(tlogs))
    pw, pc, pt = dp.sharded_encode(mesh, S, OUT_BYTES)(src, ns, norms, tlogs)
    assert np.array_equal(_np(pw).view(np.uint32), np.asarray(jw))
    assert np.array_equal(_np(pc), np.asarray(jc)) and int(pt) == int(jt)
    streams = np.zeros((4, OUT_BYTES + 96), np.uint8)
    raw = np.asarray(jw).view(np.uint8).reshape(4, -1)
    jc = np.asarray(jc)
    for k, c in enumerate(jc):
        streams[k, :c] = raw[k, :c]
    streams[3, jc[3] // 2] ^= 0x08
    jo, je = j_dp.sharded_decode(jm, S)(jnp.asarray(streams), jnp.asarray(jc),
                                        jnp.asarray(ns), jnp.asarray(norms),
                                        jnp.asarray(tlogs))
    po, pe = dp.sharded_decode(mesh, S)(streams, jc, ns, norms, tlogs)
    assert np.array_equal(_np(po), np.asarray(jo)) and np.array_equal(_np(pe), np.asarray(je))


@pytest.mark.parametrize("m", [2, 4])
def test_sharded_fse_step_ok_with_jax_total(fse_inputs, m):
    from finitestateentropy_tpu.parallel import dp as j_dp

    src, ns, norms, tlogs = compat_inputs(2 * m, 1024)
    ok, total = dp.sharded_fse_step(make_mesh(m, device="cpu"), 1024)(src, ns, norms, tlogs)
    j_ok, j_total = j_dp.sharded_fse_step(_jax_mesh(m), 1024)(src, ns, norms, tlogs)
    assert int(ok) == 1 and bool(j_ok)
    assert int(total) == int(j_total)


def test_sharded_huf_steps_equal_jax_dp_and_single_device(huf_inputs):
    import jax.numpy as jnp

    from finitestateentropy_tpu.parallel import dp as j_dp

    src, ns, val, nb, weights, tls = huf_inputs
    jm, mesh = _jax_mesh(M), make_mesh(M, device="cpu")
    jw, js = j_dp.sharded_huf_encode(jm, S, SEG_BYTES)(
        jnp.asarray(src), jnp.asarray(ns), jnp.asarray(val.astype(np.uint16)),
        jnp.asarray(nb.astype(np.uint8)))
    pw, ps = dp.sharded_huf_encode(mesh, S, SEG_BYTES)(src, ns, val, nb)
    w1, s1 = huf_kernels.huf_encode_4x_batch(*(torch.from_numpy(a) for a in
                                               (src, ns, val, nb)), S, SEG_BYTES)
    assert torch.equal(pw, w1) and torch.equal(ps, s1)
    assert np.array_equal(_np(pw).view(np.uint32), np.asarray(jw))
    assert np.array_equal(_np(ps), np.asarray(js))
    sizes = _np(ps).reshape(-1)
    streams = np.zeros((16, 2 * S // 4), np.uint8)
    raw = _np(pw).view(np.uint8).reshape(16, -1)
    for r, c in enumerate(sizes):
        streams[r, :c] = raw[r, :c]
    streams[5, sizes[5] - 1] = 0                # block 1, stream 1: no endMark
    nout = np.full(16, S // 4, np.int32)
    tlogs = np.repeat(tls, 4)
    jo, je = j_dp.sharded_huf_decode(jm, S // 4)(
        jnp.asarray(streams), jnp.asarray(sizes), jnp.asarray(nout), jnp.asarray(tlogs),
        jnp.asarray(weights), jnp.asarray(tls))
    po, pe = dp.sharded_huf_decode(mesh, S // 4)(streams, sizes, nout, tlogs, weights, tls)
    assert np.array_equal(_np(po), np.asarray(jo)) and np.array_equal(_np(pe), np.asarray(je))
    assert _np(pe).tolist() == [False] * 5 + [True] + [False] * 10
    bt, nt = huf_kernels.build_dtables_x1(torch.from_numpy(weights), torch.from_numpy(tls))
    o1, e1 = huf_kernels.huf_decode_4x1_batch(
        *(torch.from_numpy(a) for a in (streams, sizes, nout, tlogs)),
        (bt.repeat_interleave(4, 0), nt.repeat_interleave(4, 0)), S // 4)
    assert torch.equal(po, o1) and torch.equal(pe, e1)


@pytest.mark.parametrize("codec", ["fse", "huf"])
def test_codec_mesh_frames_equal_single_device(codec):
    """Mesh frames equal single-device frames and decode over the mesh; 5
    blocks pad to 6 (row 0 repeated) on a 2-mesh and to 8 on a 4-mesh."""
    data = generate_proba(80)[: 4 * S + 1000]
    cls = FseTpuCodec if codec == "fse" else HufTpuCodec
    one = cls(S, device="cpu")
    blob = fio.compress_bytes(data, codec, 1, one.compress_blocks)
    for mesh in (2, make_mesh(4, device="cpu")):
        c = cls(S, mesh=mesh, device="cpu")
        assert c._get_mesh() is not None
        assert fio.compress_bytes(data, codec, 1, c.compress_blocks) == blob
        assert fio.decompress_bytes(blob, c.decompress_blocks) == data


def test_dryrun_compat_step():
    """The graft entry's step on a 4-mesh: ok, and the total of JAX's
    sharded_fse_step on the same 8 blocks."""
    from finitestateentropy_tpu.parallel import dp as j_dp

    lines = []
    _compat_dryrun(make_mesh(4, device="cpu"), 4, lines.append)
    _ok, total = j_dp.sharded_fse_step(_jax_mesh(4), 1024)(*compat_inputs(8))
    assert lines == [f"dryrun_multichip(4): compat ok, total = {int(total)} bytes"]
