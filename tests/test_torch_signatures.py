"""The port's entry points take the JAX package's positional order.

Each of turbo_compress_device, turbo_decompress_device,
turbo16_compress_device and turbo16_decompress_device names its
parameters as the JAX entry does, in the same order (``interpret``
included), with ``device`` added last; a positional call in JAX's order
writes the JAX entry's frames.  interpret=True runs the plain PyTorch
versions of the kernels on the entry's device: the frames are the same
and no kernel is launched, even where the wrappers would otherwise
launch (here faked: the wrappers are told their inputs lie on a card, and
a launch raises).  The package exports the JAX package's lazy names.

Every public function both packages define (the kernel wrappers and the
mesh steps among them) takes the JAX function's parameters in its order,
with the port's own (device, block_size) after them; a positional call in
JAX's order (fullbench's stages 207 and 209) gives JAX's result.
api.prep_group takes the stats from the native library, as JAX's does,
and the frames stay the same.
"""
import ast
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

import finitestateentropy_tpu.turbo as j_turbo
import finitestateentropy_tpu_torch.turbo as turbo
from finitestateentropy_tpu.turbo import api as j_api
from finitestateentropy_tpu.turbo.rans import rans_compress as j_twin
from finitestateentropy_tpu_torch.turbo import api, pair, quad
from finitestateentropy_tpu_torch.turbo import kernels as v0
from finitestateentropy_tpu_torch.turbo import rans_kernels as rk
from finitestateentropy_tpu_torch.turbo.format import (parse_group,
                                                       turbo_fse_compress)
from finitestateentropy_tpu_torch.turbo.rans16 import parse_rans16_group
from finitestateentropy_tpu_torch.turbo.state import to_tensors
from finitestateentropy_tpu_torch.utils import generate_proba

ENTRIES = ("turbo_compress_device", "turbo_decompress_device",
           "turbo16_compress_device", "turbo16_decompress_device")
LAZY = {"pair_compress": pair, "pair_decompress": pair,
        "quad_compress": quad, "quad_decompress": quad}


def _u16_symbols(n: int) -> np.ndarray:
    rng = np.random.default_rng(1)
    return np.clip((rng.pareto(1.2, n) * 50).astype(np.int64), 0,
                   1023).astype(np.uint16)


@pytest.mark.parametrize("name", ENTRIES)
def test_entry_parameters_follow_jax_order(name):
    port = list(inspect.signature(getattr(api, name)).parameters)
    jax = list(inspect.signature(getattr(j_api, name)).parameters)
    assert port == jax + ["device"]
    assert "interpret" in port[1:3]


@pytest.mark.parametrize("name", ENTRIES)
def test_entry_defaults_equal_jax(name):
    port = inspect.signature(getattr(api, name)).parameters
    jax = inspect.signature(getattr(j_api, name)).parameters
    for p, jp in zip(port.values(), jax.values()):
        assert p.default == jp.default, p.name


@pytest.mark.parametrize("every", [False, True])
def test_positional_compress_in_jax_order_writes_jax_frames(every):
    """JAX turbo_compress_device(d, 1 << 20, interpret, 11) writes
    tableLog-11 speed frames; so does the port's positional call (every:
    all eleven JAX parameters positional, the byte wire)."""
    data = generate_proba(80)[:40960]
    tail = (True, 0, False, 0, 0, 0) if every else ()
    want = j_api.turbo_compress_device(data, 1 << 20, True, 11, *tail)
    got = api.turbo_compress_device(data, 1 << 20, False, 11, *tail,
                                    device="cpu")
    assert got == want
    if every:
        assert got == j_twin(data, table_log=11)
    assert api.turbo_decompress_device(got, False, 0, 1, device="cpu") == data


def test_positional_compress16_in_jax_order_writes_jax_frames():
    """JAX turbo16_compress_device(s, 1 << 19, interpret) writes speed
    frames (steptots is the fourth parameter), as the port now does."""
    s = _u16_symbols(20000)
    want = j_api.turbo16_compress_device(s, 1 << 19, True)
    got = api.turbo16_compress_device(s, 1 << 19, False, device="cpu")
    assert got == want
    assert api.parse_groups(got, parse_rans16_group)[0][8] is not None
    assert np.array_equal(
        api.turbo16_decompress_device(got, False, 8, device="cpu"), s)


@pytest.fixture
def launches_refused(monkeypatch):
    """The wrappers see every input as lying on a card, and a launch raises:
    only interpret=True gets through."""
    def refuse(*_a, **_k):
        raise RuntimeError("launch refused")

    for mod in (rk, v0):
        monkeypatch.setattr(mod, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(rk, "_launch", refuse)
    monkeypatch.setattr(v0, "_launch", refuse)
    rk.reset_launches()
    yield
    rk.reset_launches()


MODES = {"default": {}, "byte": dict(pair=0, quad=0),
         "ratio": dict(steptots=False), "totals": dict(totals_only=True),
         "mesh_byte": dict(pair=0, quad=0, mesh=2),
         "mesh_ratio": dict(steptots=False, mesh=2)}


@pytest.mark.parametrize("mode", list(MODES))
def test_interpret_runs_plain_versions(mode, launches_refused):
    kw = MODES[mode]
    data = generate_proba(80)[:3 * 8192 + 1000]
    blob = api.turbo_compress_device(data, 8192, True, device="cpu", **kw)
    assert not any(rk.launches.values())
    with pytest.raises(RuntimeError, match="launch refused"):
        api.turbo_compress_device(data, 8192, False, device="cpu", **kw)
    assert api.turbo_decompress_device(blob, True, kw.get("mesh", 0),
                                       device="cpu") == data
    with pytest.raises(RuntimeError, match="launch refused"):
        api.turbo_decompress_device(blob, False, kw.get("mesh", 0),
                                    device="cpu")
    assert not any(rk.launches.values())


@pytest.mark.parametrize("steptots", [True, False])
def test_interpret_runs_plain_versions_u16(steptots, launches_refused):
    s = _u16_symbols(3 * 4096 + 100)
    blob = api.turbo16_compress_device(s, 4096, True, steptots, device="cpu")
    with pytest.raises(RuntimeError, match="launch refused"):
        api.turbo16_compress_device(s, 4096, False, steptots, device="cpu")
    for windows in (0, 8):
        assert np.array_equal(api.turbo16_decompress_device(
            blob, True, windows, device="cpu"), s)
    with pytest.raises(RuntimeError, match="launch refused"):
        api.turbo16_decompress_device(blob, False, device="cpu")
    assert not any(rk.launches.values())


def test_interpret_runs_plain_v0_decode(launches_refused):
    data = generate_proba(80)[:12288]
    cs, tbl, init, st, t4, wrows = v0.stage_groups(
        [parse_group(turbo_fse_compress(data))[0]])
    ins = list(to_tensors("cpu", csize_bits=cs, tables=tbl, init_states=init,
                          streams=st).values())
    out, err = v0.turbo_fse_decode(*ins, t4, wrows, True)
    assert not err.any() and out.numpy().astype("<i4").tobytes()[:len(data)] == data
    with pytest.raises(RuntimeError, match="launch refused"):
        v0.turbo_fse_decode(*ins, t4, wrows)
    assert not any(rk.launches.values())


@pytest.mark.parametrize("kw", [dict(pair=0, quad=0), {}, dict(steptots=False),
                                dict(totals_only=True)])
def test_interpret_on_cpu_gives_the_same_frames(kw):
    data = generate_proba(80)[:2 * 8192 + 77]
    one = api.turbo_compress_device(data, 8192, True, device="cpu", **kw)
    assert one == api.turbo_compress_device(data, 8192, False, device="cpu", **kw)
    assert api.turbo_decompress_device(one, True, device="cpu") == data


@pytest.mark.parametrize("name", list(ENTRIES) + list(LAZY))
def test_lazy_names_resolve(name):
    mod = LAZY.get(name, api)
    assert getattr(turbo, name) is getattr(mod, name)
    assert hasattr(j_turbo, name)
    with pytest.raises(AttributeError):
        getattr(turbo, "no_such_entry")


# ---------------------------------------------------------------------------
# the compat codecs: ops, models, the frame layer and the sharded steps
# ---------------------------------------------------------------------------

# (module, name, the port's parameters added after JAX's)
COMPAT_API = [
    ("ops.bitio", "bytes_to_words", []), ("ops.bitio", "words_to_bytes", []),
    ("ops.bitio", "read_bits", []), ("ops.bitio", "pack_fields", []),
    ("ops.bitio", "initial_bitpos", []),
    ("ops.fse_tables", "build_ctables", []), ("ops.fse_tables", "build_dtables", []),
    ("ops.fse_kernels", "fse_encode_batch", []),
    ("ops.fse_kernels", "fse_decode_batch", []),
    ("ops.huf_kernels", "huf_encode_4x_batch", []),
    ("ops.huf_kernels", "build_dtables_x1", []),
    ("ops.huf_kernels", "huf_decode_4x1_batch", []),
    ("ops.huf_kernels", "huf_decode_4x2_batch", []),
    ("ops.huf_kernels", "pack_dtable_x2", []),
    ("models.fse_codec", "FseTpuCodec", ["device"]),
    ("models.huf_codec", "HufTpuCodec", ["device"]),
    ("models", "AutoTpuCodec", ["device"]),
    ("models", "get_batch_codec", ["block_size", "device"]),
    ("models.select", "choose_codec", []),
    ("io.frame", "compress_bytes", []), ("io.frame", "decompress_bytes", []),
    ("io.frame", "compress_file", []), ("io.frame", "decompress_file", []),
    ("parallel.dp", "sharded_encode", []), ("parallel.dp", "sharded_decode", []),
    ("parallel.dp", "sharded_huf_encode", []),
    ("parallel.dp", "sharded_huf_decode", []),
    ("parallel.dp", "sharded_fse_step", []),
]


def _params(obj) -> list[tuple[str, object]]:
    sig = inspect.signature(obj)
    return [(p.name, p.default) for p in sig.parameters.values()]


@pytest.mark.parametrize("module,name,extra", COMPAT_API,
                         ids=[f"{m}.{n}" for m, n, _e in COMPAT_API])
def test_compat_api_follows_jax(module, name, extra):
    """The same parameters, in JAX's order and with JAX's defaults; the
    port's additions (device, and the codecs' block size) come last."""
    import importlib

    port = getattr(importlib.import_module(f"finitestateentropy_tpu_torch.{module}"), name)
    jax = getattr(importlib.import_module(f"finitestateentropy_tpu.{module}"), name)
    p, j = _params(port), _params(jax)
    assert [n for n, _d in p] == [n for n, _d in j] + extra
    assert p[: len(j)] == j
    if isinstance(port, type):
        for meth in ("compress_blocks", "decompress_blocks"):
            assert _params(getattr(port, meth)) == _params(getattr(jax, meth))


# ---------------------------------------------------------------------------
# every public function both packages define: JAX's parameters, in JAX's
# order, with the port's own after them
# ---------------------------------------------------------------------------

REPO = Path(__file__).resolve().parent.parent
PORT_ONLY = {"device", "block_size"}


def _ast_params(path: Path) -> dict[str, list[str]]:
    """{name: parameter names} of a module's public functions and of its
    public classes' __init__ and public methods, read by AST."""
    def names(f):
        a = f.args
        return ([p.arg for p in a.posonlyargs + a.args]
                + ([f"*{a.vararg.arg}"] if a.vararg else [])
                + [p.arg for p in a.kwonlyargs])

    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            out[node.name] = names(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for m in node.body:
                if isinstance(m, ast.FunctionDef) and (
                        m.name == "__init__" or not m.name.startswith("_")):
                    out[f"{node.name}.{m.name}"] = names(m)
    return out


def _shared() -> list[tuple[str, str, list[str], list[str]]]:
    jax_pkg, port_pkg = REPO / "finitestateentropy_tpu", REPO / "finitestateentropy_tpu_torch"
    out = []
    for f in sorted(jax_pkg.rglob("*.py")):
        rel = f.relative_to(jax_pkg)
        j, p = _ast_params(f), _ast_params(port_pkg / rel)
        out += [(str(rel), n, j[n], p[n]) for n in sorted(set(j) & set(p))]
    return out


SHARED = _shared()


def test_shared_functions_cover_the_wrappers_and_mesh_steps():
    names = {n for _r, n, _j, _p in SHARED}
    assert len(SHARED) > 150
    assert {"rans_encode2", "rans_encode", "rans_decode", "rans_decode_v2",
            "rans_decode_w", "sharded_turbo_roundtrip", "sharded_turbo_decode_w",
            "prep_group", "bench_files"} <= names


@pytest.mark.parametrize("rel,name,jax_params,port_params", SHARED,
                         ids=[f"{r}:{n}" for r, n, _j, _p in SHARED])
def test_shared_function_takes_jax_parameters_in_order(rel, name, jax_params,
                                                       port_params):
    assert port_params[:len(jax_params)] == jax_params
    assert set(port_params[len(jax_params):]) <= PORT_ONLY


def _stage_encode_inputs(gsz: int):
    """One group of fullbench's 20% proba data, as its stages stage it:
    (fc, mg, srcw, t4, hcap) numpy arrays."""
    from finitestateentropy_tpu.turbo.api import _hrows_cap, _prep_group
    from finitestateentropy_tpu.turbo.format import _pad_n
    from finitestateentropy_tpu.turbo.rans_kernels import pack_rans_ctables

    base = generate_proba(20)
    src = np.frombuffer((base * 2)[:gsz], np.uint8)
    norm, _msv, _nc, mfs = _prep_group(src)
    n_pad = _pad_n(gsz)
    fc, mg = pack_rans_ctables(norm)
    pad = np.full(n_pad, mfs, np.uint8)
    pad[:gsz] = src
    return (fc[None], mg[None], pad.view("<i4").reshape(1, -1, 128),
            n_pad // 4096, _hrows_cap(n_pad))


def test_positional_rans_encode2_in_jax_order_equals_jax():
    """fullbench stage 207's argument list (the row-local placement),
    positional: the port's call equals JAX's with interpret=True."""
    import jax.numpy as jnp

    from finitestateentropy_tpu.turbo.rans_kernels import rans_encode2 as j_enc

    fc, mg, srcw, t4, hcap = _stage_encode_inputs(1 << 16)
    want = [np.asarray(a) for a in j_enc(jnp.asarray(fc), jnp.asarray(mg),
                                         jnp.asarray(srcw), t4, hcap, True,
                                         False, 11, True, 0, True)]
    rk.reset_launches()
    got = [a.numpy() for a in rk.rans_encode2(*(torch.from_numpy(a) for a in (fc, mg, srcw)),
                                              t4, hcap, False, False, 11, True, 0, True)]
    assert not any(rk.launches.values())
    cs = int(want[2][0])
    assert int(got[2][0]) == cs
    # the first csize halfwords; JAX leaves the rest unwritten
    assert np.array_equal(got[0].reshape(-1).view("<u2")[:cs],
                          want[0].reshape(-1).view("<u2")[:cs])
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[3], want[3])


def test_positional_rans_decode_w_in_jax_order_equals_jax():
    """fullbench stage 209's argument list (quad, S = 128, at its smallest
    group: 512 KiB), positional: the port's call equals JAX's with
    interpret=True."""
    import jax.numpy as jnp

    from finitestateentropy_tpu.turbo.quad import (QUAD_TABLELOG, _pad_q,
                                                   parse_quad_group,
                                                   quad_compress)
    from finitestateentropy_tpu.turbo.rans_kernels import (pack_quad_dtable,
                                                           pack_stream_words,
                                                           rans_decode_w as j_w,
                                                           stream_word_rows)

    data = generate_proba(80, 1 << 19)
    (qn, qcs, qtl, _f, qnorm, _m, qinit, qpay, qst, quads, _e), _ = \
        parse_quad_group(quad_compress(data, table_log=QUAD_TABLELOG))
    steps = _pad_q((qn + 3) // 4) // 1024
    qhrows = api._round8((qcs + 127) // 128 + 16)
    dq = [np.full(1, qcs, np.int32), pack_quad_dtable(qnorm, quads, qtl)[None],
          qinit.view(np.int32).reshape(1, 8, 128),
          pack_stream_words(qpay, stream_word_rows(qhrows))[None],
          qst.astype(np.int32)[None]]
    dq = [a.view(np.int32) if a.dtype == np.uint32 else a for a in dq]
    j_out, j_err = j_w(*(jnp.asarray(a) for a in dq), steps, qhrows, 8, qtl,
                       128, True, False, False, False, True)
    out, err = rk.rans_decode_w(*(torch.from_numpy(a) for a in dq), steps,
                                qhrows, 8, qtl, 128, False, False, False,
                                False, True)
    assert err.tolist() == np.asarray(j_err).tolist() == [0]
    assert np.array_equal(out.numpy(), np.asarray(j_out))
    vals = out.numpy().reshape(-1).view(np.uint32)[:(qn + 3) // 4].copy()
    assert quad.apply_escapes(vals, _e).tobytes()[:qn] == data


CORPORA = {"p80": 80, "p14": 14, "p02": 2}


@pytest.mark.parametrize("name", list(CORPORA) + ["rle"])
def test_prep_group_equals_jax(name):
    """api.prep_group (native C when built, else _prep_group) against JAX's
    prep_group, at the speed and ratio tableLogs."""
    from finitestateentropy_tpu_torch import native

    assert native.available()       # the path under test is the native one
    chunk = (np.full(70000, 7, np.uint8) if name == "rle"
             else np.frombuffer(generate_proba(CORPORA[name], 1 << 17), np.uint8))
    for tlog in (10, 11):
        got, want = api.prep_group(chunk, tlog), j_api.prep_group(chunk, tlog)
        if want is None:
            assert got is None and name in ("rle", "p02")
            continue
        assert np.array_equal(got[0], want[0]) and got[0].dtype == want[0].dtype
        assert got[1:] == want[1:]
        fallback = api._prep_group(chunk, tlog)
        assert np.array_equal(got[0], fallback[0]) and got[1:] == fallback[1:]


@pytest.mark.parametrize("kw", [{}, dict(pair=0, quad=0), dict(steptots=False)])
def test_plan_encode_frames_unchanged_by_the_native_prep(kw, monkeypatch):
    """The frames with the native prep equal those of the numpy prep the
    port ran before (and JAX's twin on the byte wire)."""
    parts = [generate_proba(p, 40960) for p in (80, 14, 2)] + [b"\x05" * 40960]
    data = b"".join(parts)
    got = api.turbo_compress_device(data, 40960, device="cpu", **kw)
    monkeypatch.setattr(api, "prep_group", api._prep_group)
    assert api.turbo_compress_device(data, 40960, device="cpu", **kw) == got
    if kw.get("pair") == 0:
        assert got == b"".join(j_twin(p, table_log=10) for p in parts)
