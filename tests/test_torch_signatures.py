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
"""
import inspect

import numpy as np
import pytest

import finitestateentropy_tpu.turbo as j_turbo
import finitestateentropy_tpu_torch.turbo as turbo
from finitestateentropy_tpu.turbo import api as j_api
from finitestateentropy_tpu.turbo.rans import rans_compress as j_twin
from finitestateentropy_tpu_torch.turbo import api, pair, quad
from finitestateentropy_tpu_torch.turbo import kernels as v0
from finitestateentropy_tpu_torch.turbo import rans_kernels as rk
from finitestateentropy_tpu_torch.turbo.format import (parse_group,
                                                       turbo_fse_compress)
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
    assert api.parse_groups16(got)[0][8] is not None
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
