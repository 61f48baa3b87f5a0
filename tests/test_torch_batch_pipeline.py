"""The one TurboRANS batch pipeline behind the three entry points.

The host entries (turbo_decompress_device), the U16 codec
(turbo16_decompress_device) and the resident pipeline
(rans_decompress_resident) stage their batches with one stager and pick
a batch's decode entry in one place, api._decode_batch.  Held here: each
batch of every wire and section reaches the entry the JAX package's
_window_dispatch picks for the host and U16 entries at each ``windows``
setting, and rans_decode_v2 (rans_decode for v1 groups) for the resident
one; and every stage of the host entries passes through api._stage as a
module global, which the benchmark harness replaces to mark its spans.
"""
from contextlib import contextmanager
from functools import lru_cache

import numpy as np
import pytest
import torch

from finitestateentropy_tpu.turbo import rans as j_rans
from finitestateentropy_tpu.turbo import rans16 as j_rans16
from finitestateentropy_tpu.turbo.api import _window_dispatch as j_dispatch
from finitestateentropy_tpu.turbo.pair import FLAG_PAIR
from finitestateentropy_tpu.turbo.quad import FLAG_QUAD
from finitestateentropy_tpu_torch.turbo import api
from finitestateentropy_tpu_torch.turbo.device_api import rans_decompress_resident
from finitestateentropy_tpu_torch.utils import generate_proba

GROUP = 131072          # byte groups of 32 supercycles: windowed-eligible
ENTRIES = ("rans_decode", "rans_decode_v2", "rans_decode_w")


def _symbols(hi: int, scale: int, a: float, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    s = np.clip((rng.pareto(a, n) * scale).astype(np.int64), 0, hi)
    return s.astype(np.uint16)


@lru_cache(maxsize=None)
def _stream(entry: str):
    """(blob, original) covering every wire and section the entry reads."""
    if entry == "u16":
        parts = [(_symbols(1023, 50, 1.2, 2 * GROUP, 1), True),
                 (_symbols(4095, 300, 1.0, GROUP, 2), True),
                 (_symbols(1023, 50, 1.2, GROUP // 2, 3), False)]
        blob = b"".join(api.turbo16_compress_device(s, GROUP, steptots=st,
                                                    device="cpu")
                        for s, st in parts)
        return blob, np.concatenate([s for s, _ in parts])
    p80, p14 = generate_proba(80, 2 * GROUP), generate_proba(14, GROUP)
    parts = [(p14, {}), (p80[:GROUP], {"totals_only": True}),
             (p80[:GROUP // 2], {"steptots": False})]
    if entry == "host":        # the multi-byte wires, speed and ratio
        parts += [(p80, {"pair": -1, "quad": -1}), (p80[:GROUP], {"quad": 1}),
                  (p80[:GROUP // 2], {"pair": 1, "steptots": False})]
    blob = b"".join(api.turbo_compress_device(
        d, GROUP, **{"pair": 0, "quad": 0, **kw}, device="cpu")
        for d, kw in parts)
    return blob, b"".join(d for d, _ in parts)


def _frame_batches(entry: str, blob: bytes) -> set:
    """{(wire, section kind)} of the coded groups, read by the JAX
    package's own group parsers."""
    out, pos = set(), 0
    while pos < len(blob):
        if entry == "u16":
            g, used = j_rans16.parse_rans16_group(blob[pos:])
            wire = "u16x" if g[5] > 1023 else "u16"
        else:
            g, used = j_rans.parse_rans_group(blob[pos:])
            wire = ("quad" if g[3] & FLAG_QUAD else
                    "pair" if g[3] & FLAG_PAIR else "byte")
        if not g[3] & (j_rans.FLAG_RAW | j_rans.FLAG_RLE):
            out.add((wire, 0 if g[8] is None else g[8].ndim))
        pos += used
    return out


@pytest.mark.parametrize("entry,windows", [
    ("host", 0), ("host", 1), ("host", 8), ("u16", 0), ("u16", 1), ("u16", 8),
    ("resident", 1)])
def test_decode_batches_reach_the_jax_dispatch_entry(entry, windows, monkeypatch):
    """Every decode batch calls the entry the JAX dispatch picks for its
    shape (the resident entry has no windows: it takes windows=1's
    rans_decode_v2), with the mode flags of its wire."""
    calls = []
    for name in ENTRIES:
        real = getattr(api, name)

        def spy(*a, _name=name, _real=real, **kw):
            calls.append((_name, a, kw))
            return _real(*a, **kw)
        monkeypatch.setattr(api, name, spy)
    blob, want = _stream(entry)
    if entry == "host":
        assert api.turbo_decompress_device(blob, windows=windows,
                                           device="cpu") == want
    elif entry == "u16":
        assert np.array_equal(api.turbo16_decompress_device(
            blob, windows=windows, device="cpu"), want)
    else:
        out = rans_decompress_resident(blob, device="cpu")
        assert out.dtype == torch.uint8 and out.numpy().tobytes() == want
    seen = set()
    for name, a, kw in calls:
        modes = {k: kw.get(k, False) for k in ("u16", "u16x", "pair", "quad")}
        wire = ("quad" if modes["quad"] else "pair" if modes["pair"] else
                "u16x" if modes["u16x"] else "u16" if modes["u16"] else "byte")
        if name == "rans_decode":
            seen.add((wire, 0))
            continue
        totals = a[4].dim() == 2
        seen.add((wire, 1 if totals else 2))
        t4, hrows, tlog, G = a[5], a[6], a[8], a[0].shape[0]
        routed = j_dispatch(windows, t4, hrows, tlog, G, totals, **modes)
        assert name == ("rans_decode_w" if routed[0] else "rans_decode_v2")
    assert seen == _frame_batches(entry, blob)
    if windows == 8:            # a forced window reaches rans_decode_w
        assert any(name == "rans_decode_w" for name, _a, _kw in calls)


def test_host_stages_pass_through_a_patched_stage(monkeypatch):
    """Replace api._stage with a recorder, as the benchmark harness does
    during traced runs: every stage of both host entries still passes
    through it and lands in api.stage_seconds."""
    seen = []
    stage = api._stage

    @contextmanager
    def marked(name, dev):
        seen.append(name)
        with stage(name, dev):
            yield

    monkeypatch.setattr(api, "_stage", marked)
    monkeypatch.setattr(api, "stage_seconds", {})
    data = generate_proba(80, 2 * 65536 + 1000)
    blob = api.turbo_compress_device(data, 65536, device="cpu")
    assert api.turbo_decompress_device(blob, device="cpu") == data
    assert set(seen) == set(api.stage_seconds) == {
        "c_prep", "c_stage", "c_h2d", "c_kernel", "c_d2h", "c_frames",
        "d_parse", "d_stage", "d_h2d", "d_kernel", "d_d2h", "d_copy",
        "d_join"}
