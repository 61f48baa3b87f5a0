"""The flat encode placement (rans_encode2 with rowloc=False) and the byte
mode of the v1 encode (rans_encode), against the JAX package.

The plain PyTorch versions on the CPU must equal the JAX kernels in
interpret mode (_rans_encode2_kernel, _rans_encode_kernel) in the first
csize halfwords (JAX leaves the stream past csize unwritten), the final
states, csize and the step counts; the byte v1 wire must equal the flat
wire for every force_chunk, as tests/test_turbo.py:328-365 and :424-460
hold it for the JAX kernels.  Tests marked ``gpu`` hold the CUDA kernel
against the plain versions.  Tolerance is 0 throughout: the codec is
integer and bit-exact.
"""
import numpy as np
import pytest
import torch

from finitestateentropy_tpu_torch.refimpl.norm import fse_normalize_count
from finitestateentropy_tpu_torch.turbo import rans_kernels as rk
from finitestateentropy_tpu_torch.turbo.api import (STAGE_BATCH, _hrows_cap,
                                                    _prep_group, plan_encode16)
from finitestateentropy_tpu_torch.turbo.format import TURBO_STEP_SYMS, _pad_n
from finitestateentropy_tpu_torch.turbo.rans16 import _pad_n16
from finitestateentropy_tpu_torch.turbo.state import to_tensors
from finitestateentropy_tpu_torch.turbo.tables import (pack_rans16_ctables,
                                                       pack_rans_ctables)
from finitestateentropy_tpu_torch.utils import generate_proba

CORPORA = {"p80": 80, "p14": 14, "p02": 2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the GPU)")
    return torch.device("cuda")


def _byte_inputs(gsz: int = 16384, names=("p80",)):
    """fc, mg [G,2,128], srcw and (t4, hcap) of one group per corpus at
    tableLog 11, staged as tests/test_turbo.py:338-350 does it."""
    n_pad = _pad_n(gsz)
    t4 = n_pad // TURBO_STEP_SYMS
    fcs, mgs, srcs = [], [], []
    for name in names:
        src = np.frombuffer(generate_proba(CORPORA[name], gsz), np.uint8)
        norm, _msv, _nc, mfs = _prep_group(src)
        fc, mg = pack_rans_ctables(norm)
        pad = np.full(n_pad, mfs, np.uint8)
        pad[:gsz] = src
        fcs.append(fc)
        mgs.append(mg)
        srcs.append(pad.view("<u4").view(np.int32).reshape(t4 * 8, 128))
    return np.stack(fcs), np.stack(mgs), np.stack(srcs), t4, _hrows_cap(n_pad)


def _u16_inputs(nsym: int):
    """One group of u16 symbols <= 1023 on 8-chunk tables, staged as
    tests/test_turbo.py:434-448 does it: (fc, mg, srcw, t2, hcap)."""
    rng = np.random.default_rng(31)
    d = np.clip((rng.pareto(1.2, nsym) * 50).astype(np.int64),
                0, 1023).astype(np.uint16)
    count = np.bincount(d, minlength=1024)
    max_sv = int(d.max())
    norm, _tl = fse_normalize_count(11, count[: max_sv + 1], nsym, max_sv)
    fc, mg = pack_rans16_ctables(norm)
    n_pad = _pad_n16(nsym)
    pad = np.full(n_pad, int(count.argmax()), np.uint16)
    pad[:nsym] = d
    t2 = n_pad // 2048
    srcw = pad.view("<u4").view(np.int32).reshape(1, t2 * 8, 128)
    return fc[None], mg[None], srcw, t2, (n_pad // 128 + 16 + 7) // 8 * 8


def _cpu(fc, mg, srcw):
    ins = to_tensors("cpu", fc_tables=fc, magic_tables=mg, src_words=srcw)
    return ins["fc_tables"], ins["magic_tables"], ins["src_words"]


def _wire(stream, cs: int, packed: bool) -> bytes:
    """The first cs halfwords of an encode's stream: packed words (encode2)
    or one halfword per i32 (the v1 encode)."""
    s = np.asarray(stream)
    if packed:
        return np.ascontiguousarray(s).tobytes()[: 2 * cs]
    return s.reshape(-1)[:cs].astype(np.uint16).astype("<u2").tobytes()


def _same(got, want, packed: bool) -> None:
    """A port encode's outputs against a JAX encode's, group by group."""
    g = [None if a is None else np.asarray(a) for a in got]
    w = [None if a is None else np.asarray(a) for a in want]
    assert g[0].shape == w[0].shape and g[0].dtype == w[0].dtype
    assert np.array_equal(g[2], w[2])
    for j, cs in enumerate(w[2].tolist()):
        assert _wire(g[0][j], cs, packed) == _wire(w[0][j], cs, packed)
    assert np.array_equal(g[1], w[1])
    assert (g[3] is None) == (w[3] is None)
    if w[3] is not None:
        assert np.array_equal(g[3], w[3])


@pytest.mark.parametrize("steptots", [True, False])
def test_plain_flat_encode_matches_jax_interpret(steptots):
    """Byte tables, with the step counts on and off (the mesh speed and
    ratio encodes), on p80, p14 and p02 groups of 16 KiB."""
    import jax.numpy as jnp

    from finitestateentropy_tpu.turbo.rans_kernels import rans_encode2 as j_encode2

    fc, mg, srcw, t4, hcap = _byte_inputs(names=list(CORPORA))
    want = j_encode2(jnp.asarray(fc), jnp.asarray(mg), jnp.asarray(srcw), t4,
                     hcap, True, False, 11, steptots, 0, False)
    got = rk.rans_encode2(*_cpu(fc, mg, srcw), t4, hcap, False, False, 11,
                          steptots, 0, False)
    _same(got, want, True)
    assert (got[1].numpy().view(np.uint32) >= 1 << 31).any()


@pytest.mark.parametrize("force", [0, 1, 2])
def test_plain_flat_encode_u16_matches_jax_interpret(force):
    """u16 tables of 8 chunks (1024 symbols) through the flat placement, as
    the mesh u16 round trip runs them, with force_chunk 0, 1 and 2."""
    import jax.numpy as jnp

    from finitestateentropy_tpu.turbo.rans_kernels import rans_encode2 as j_encode2

    fc, mg, srcw, t2, hcap = _u16_inputs(8192)
    assert fc.shape == (1, 8, 128) and t2 == 4
    want = j_encode2(jnp.asarray(fc), jnp.asarray(mg), jnp.asarray(srcw), t2,
                     hcap, True, True, 11, True, force, False)
    got = rk.rans_encode2(*_cpu(fc, mg, srcw), t2, hcap, False, True, 11,
                          True, force, False)
    _same(got, want, True)


def test_force_chunk_keeps_the_chunking_rule():
    """force_chunk changes no output, and a step count that does not fit
    the forced chunk raises, in both packages."""
    import jax.numpy as jnp

    from finitestateentropy_tpu.turbo.rans_kernels import rans_encode2 as j_encode2

    fc, mg, srcw, t2, hcap = _u16_inputs(6144)
    assert t2 == 3
    with pytest.raises(ValueError, match="multiple of 2"):
        j_encode2(jnp.asarray(fc), jnp.asarray(mg), jnp.asarray(srcw), t2,
                  hcap, True, True, 11, True, 2)
    with pytest.raises(ValueError, match="multiple of 2"):
        rk.rans_encode2(*_cpu(fc, mg, srcw), t2, hcap, False, True, 11,
                        True, 2)
    outs = [rk.rans_encode2(*_cpu(fc, mg, srcw), t2, hcap, u16=True,
                            force_chunk=f) for f in (0, 1, 3)]
    for out in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out, outs[0]))


@pytest.mark.parametrize("steptots", [True, False])
def test_plain_byte_v1_encode_matches_jax_interpret(steptots):
    """The byte mode of rans_encode (one halfword per i32) against the JAX
    v1 encode on p80, p14 and p02 groups of 16 KiB."""
    import jax.numpy as jnp

    from finitestateentropy_tpu.turbo.rans_kernels import rans_encode as j_encode

    fc, mg, srcw, t4, hcap = _byte_inputs(names=list(CORPORA))
    want = j_encode(jnp.asarray(fc), jnp.asarray(mg), jnp.asarray(srcw), t4,
                    hcap, True, False, 11, steptots)
    got = rk.rans_encode(*_cpu(fc, mg, srcw), t4, hcap, False, False, 11,
                         steptots)
    _same(got, want, False)


def test_byte_v1_wire_equals_flat_wire():
    """tests/test_turbo.py:328-365 inside the port: the byte v1 encode's
    wire, finals and step counts equal the flat encode2's for every
    force_chunk (single chunk, 2 chunks, one chunk per supercycle)."""
    fc, mg, srcw, t4, hcap = _byte_inputs()
    s1, f1, c1, st1 = rk.rans_encode(*_cpu(fc, mg, srcw), t4, hcap)
    cs = int(c1[0])
    for force in (0, 2, 1):
        s2, f2, c2, st2 = rk.rans_encode2(*_cpu(fc, mg, srcw), t4, hcap,
                                          tlog=11, force_chunk=force)
        assert int(c2[0]) == cs
        assert _wire(s2[0], cs, True) == _wire(s1[0], cs, False), force
        assert torch.equal(f2, f1) and torch.equal(st2, st1), force


def test_u16_v1_wire_equals_flat_wire():
    """tests/test_turbo.py:424-460 inside the port: the same for u16
    symbols on 8-chunk tables."""
    fc, mg, srcw, t2, hcap = _u16_inputs(6144)
    s1, f1, c1, st1 = rk.rans_encode(*_cpu(fc, mg, srcw), t2, hcap, u16=True)
    cs = int(c1[0])
    for force in (0, 1):
        s2, f2, c2, st2 = rk.rans_encode2(*_cpu(fc, mg, srcw), t2, hcap,
                                          tlog=11, u16=True, force_chunk=force)
        assert int(c2[0]) == cs
        assert _wire(s2[0], cs, True) == _wire(s1[0], cs, False), force
        assert torch.equal(f2, f1) and torch.equal(st2, st1), force


def test_encode_mode_follows_table_width():
    """2 chunks: byte, pair (u16) or quad; 8 chunks u16; 32 chunks u16x;
    wide tables without u16=True raise."""
    z = lambda *s: torch.zeros(s, dtype=torch.int32)   # noqa: E731
    src = z(1, 8, 128)
    for nch, flags, mode in ((2, {}, "byte"), (2, dict(u16=True), "pair"),
                             (2, dict(quad=True), "quad"),
                             (8, dict(u16=True), "u16"),
                             (32, dict(u16=True), "u16x")):
        assert rk._encode_mode(z(1, nch, 128), z(1, nch, 128), src, 1,
                               flags.get("u16", False),
                               flags.get("quad", False)) == mode
    for nch, u16, quad in ((8, False, False), (32, True, True), (4, True, False)):
        with pytest.raises(ValueError, match="fc_tables"):
            rk._encode_mode(z(1, nch, 128), z(1, nch, 128), src, 1, u16, quad)


def _u16x_inputs():
    """3 groups of u16 symbols <= 4095 on 32-chunk tables at tableLog 13."""
    rng = np.random.default_rng(8)
    s = np.clip((rng.pareto(1.0, 3 << 18) * 300).astype(np.int64), 0,
                4095).astype(np.uint16)
    _c, _f, batches = plan_encode16(s, 1 << 18, True)
    ((n_pad, big, tlog), items), = batches.items()
    assert big and tlog == 13
    fc, mg, srcw = STAGE_BATCH["u16x" if big else "u16"](items, n_pad)
    return fc, mg, srcw, n_pad // 2048, (n_pad // 128 + 16 + 7) // 8 * 8, tlog


@pytest.mark.gpu
@pytest.mark.parametrize("mode,steptots", [("byte", True), ("byte", False),
                                           ("u16", True), ("u16x", True)])
def test_cuda_flat_encode_matches_plain(cuda, mode, steptots):
    if mode == "byte":
        fc, mg, srcw, t4, hcap = _byte_inputs(1 << 20, list(CORPORA))
        tlog, u16 = 11, False
    elif mode == "u16":
        fc, mg, srcw, t4, hcap = _u16_inputs(1 << 19)
        fc, mg, srcw = (np.concatenate([a] * 3) for a in (fc, mg, srcw))
        tlog, u16 = 11, True
    else:
        fc, mg, srcw, t4, hcap, tlog = _u16x_inputs()
        u16 = True
    ins = to_tensors(cuda, fc_tables=fc, magic_tables=mg, src_words=srcw)
    args = (*ins.values(), t4, hcap, tlog)
    key = f"rans_encode2_flat:{mode}"
    before = rk.launches[key]
    got = rk.rans_encode2(*args[:5], tlog=tlog, u16=u16, steptots=steptots)
    torch.cuda.synchronize()
    assert rk.launches[key] == before + 1
    want = rk.rans_encode2_plain(*args, u16=u16, steptots=steptots)
    assert (got[3] is None) == (want[3] is None) == (not steptots)
    for g, w in zip(got, want):
        assert g is None or torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("steptots", [True, False])
def test_cuda_byte_v1_encode_matches_plain(cuda, steptots):
    fc, mg, srcw, t4, hcap = _byte_inputs(1 << 20, list(CORPORA))
    ins = to_tensors(cuda, fc_tables=fc, magic_tables=mg, src_words=srcw)
    args = (*ins.values(), t4, hcap, False, 11, steptots)
    before = rk.launches["rans_encode:byte"]
    got = rk.rans_encode(*args[:5], False, *args[5:])
    torch.cuda.synchronize()
    assert rk.launches["rans_encode:byte"] == before + 1
    for g, w in zip(got, rk.rans_encode_plain(*args)):
        assert (g is None) == (w is None)
        assert g is None or torch.equal(g, w)
