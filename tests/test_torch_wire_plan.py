"""turbo/wire_plan.py: the native plan of a group's pair and quad wires
(csrc/wire_plan_host.c) gives what pair.prep_pair_group and
quad.prep_quad_group give, dict for dict and dtype for dtype, and the byte
counts np.bincount gives; plan_encode's frames are the same with the
library and without it (and the JAX package's for the default flags);
`wire_plan.counts` tallies each planned group once, as native or python."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import finitestateentropy_tpu.turbo.api as j_api
from finitestateentropy_tpu.turbo.pair import pair_compress as j_pair_twin
from finitestateentropy_tpu.turbo.pair import prep_pair_group as j_prep_pair
from finitestateentropy_tpu.turbo.quad import prep_quad_group as j_prep_quad
from finitestateentropy_tpu.turbo.quad import quad_compress as j_quad_twin
from finitestateentropy_tpu.turbo.rans import rans_compress as j_twin
from finitestateentropy_tpu_torch.turbo import api, pair, quad
from finitestateentropy_tpu_torch.turbo import wire_plan as wp
from finitestateentropy_tpu_torch.utils import generate_proba

REPO = Path(__file__).resolve().parent.parent


def _equal(a, b) -> bool:
    """Deep equality of the host modules' results (dicts, tuples, arrays)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    return a == b


def _items(values, counts, dtype, seed=0) -> np.ndarray:
    """A group whose `dtype` view (pairs: <u2, quads: <u4) holds each value
    counts times, in a seeded shuffle."""
    arr = np.repeat(np.asarray(values, dtype), counts)
    np.random.default_rng(seed).shuffle(arr)
    return arr.astype(np.dtype(dtype).newbyteorder("<")).view(np.uint8)


def _distinct(k: int, dtype, seed: int) -> np.ndarray:
    """k distinct values of dtype (random, and far from each other)."""
    rng = np.random.default_rng(seed)
    top = 1 << 16 if dtype == np.uint16 else 1 << 32
    vals = np.unique(rng.integers(0, top, 4 * k, dtype=np.int64))
    return rng.permutation(vals)[:k].astype(dtype)


def _alphabet(k: int, dtype, seed: int = 1) -> np.ndarray:
    """Exactly k distinct values, the last two rare (under 1% of items)."""
    counts = np.r_[np.random.default_rng(seed).integers(20, 60, k - 2), 1, 1]
    return _items(_distinct(k, dtype, seed), counts, dtype, seed)


def _tie(dtype) -> np.ndarray:
    """300 distinct values; ranks 251-270 share one count, so the 255th
    place is settled by value (the stable argsort's tie-break)."""
    vals = _distinct(300, dtype, 7)
    counts = np.r_[np.arange(350, 100, -1), [2] * 20, [1] * 30]
    return _items(vals, counts, dtype, 7)


def _escapes(dtype, n_items: int, n_esc: int) -> np.ndarray:
    """255 values over n_items - n_esc items, then n_esc values seen once:
    n_esc of the items escape."""
    vals = _distinct(255 + n_esc, dtype, 11)
    kept = n_items - n_esc
    counts = np.r_[np.full(255, kept // 255), np.ones(n_esc, np.int64)]
    counts[: kept % 255] += 1
    return _items(vals, counts, dtype, 11)


def _both_escape(tail: int) -> np.ndarray:
    """Both wires keep 255 values and escape the rest: 250 common quads over
    200 common pairs, 60 rare quads over 120 rare pairs; then `tail` bytes
    ending in 0xFF, so the pair 0xFFFF (absent, or seen once and last in
    value) escapes, as does the high half of the padded last quad (no pair
    at a tail of 1 or 2)."""
    rng = np.random.default_rng(5)
    pairs = _distinct(321, np.uint16, 5)
    pairs = pairs[pairs != 0xFFFF][:320].astype(np.uint32)
    common = rng.choice(pairs[:200], (2, 250))
    vals = np.r_[common[0] | common[1] << 16, pairs[200:260] | pairs[260:] << 16]
    body = _items(vals, np.r_[np.full(250, 40), np.ones(60, np.int64)],
                  np.uint32, 5)
    return np.r_[body, np.full(tail, 0xFF, np.uint8)].astype(np.uint8)


def _p80(n: int) -> np.ndarray:
    return np.frombuffer(generate_proba(80, n), np.uint8)


# the escape limits: 0.02 x 5000 pairs and 0.01 x 10000 quads are 100.0
CASES = {
    "p80": lambda: _p80(65536),
    "p14": lambda: np.frombuffer(generate_proba(14, 65536), np.uint8),
    "p2": lambda: np.frombuffer(generate_proba(2, 65536), np.uint8),
    "rle": lambda: np.full(5000, 7, np.uint8),
    "p80_1MiB": lambda: _p80(1 << 20),
    **{f"len{n}": (lambda n=n: _p80(65536)[:n]) for n in (1, 2, 3, 5, 9001)},
    "pairs_256": lambda: _alphabet(256, np.uint16),
    "pairs_257": lambda: _alphabet(257, np.uint16),
    "quads_256": lambda: _alphabet(256, np.uint32),
    "quads_257": lambda: _alphabet(257, np.uint32),
    "pair_tie_at_255": lambda: _tie(np.uint16),
    "quad_tie_at_255": lambda: _tie(np.uint32),
    "pair_escapes_at_limit": lambda: _escapes(np.uint16, 5000, 100),
    "pair_escapes_over_limit": lambda: _escapes(np.uint16, 5000, 101),
    "quad_escapes_at_limit": lambda: _escapes(np.uint32, 10000, 100),
    "quad_escapes_over_limit": lambda: _escapes(np.uint32, 10000, 101),
    "one_pair_one_quad": lambda: np.frombuffer(b"ab" * 5000, np.uint8),
    **{f"both_escape_tail{t}": (lambda t=t: _both_escape(t)) for t in (1, 2, 3)},
}

# what each synthetic case has to reach in the numpy preps, so that it
# tests what its name says: (pair plan, quad plan), "esc" with an escape id
REACHES = {
    "pairs_256": ("no_esc", None), "pairs_257": ("esc", None),
    "quads_256": (None, "no_esc"), "quads_257": (None, "esc"),
    "pair_tie_at_255": ("esc", None), "quad_tie_at_255": (None, "esc"),
    "pair_escapes_at_limit": ("esc", None),
    "pair_escapes_over_limit": ("ineligible", None),
    "quad_escapes_at_limit": (None, "esc"),
    "quad_escapes_over_limit": (None, "ineligible"),
    "one_pair_one_quad": ("max_sv_0", "max_sv_0"),
    **{f"both_escape_tail{t}": ("esc", "esc") for t in (1, 2, 3)},
}


def _reached(plan_fn, d, frac):
    plan = plan_fn(d, frac)
    if plan is None:
        return "ineligible"
    if len(plan["counts"]) == 1:
        return "max_sv_0"
    return "no_esc" if plan["esc_id"] is None else "esc"


@pytest.fixture
def native():
    """The native library; skips only where no C compiler exists."""
    if shutil.which(os.environ.get("CC") or "cc") is None:
        pytest.skip("no C compiler: the native wire plan cannot be built")
    lib = wp._load()
    assert lib is not None, "a C compiler exists but the library did not load"
    return lib


@pytest.fixture
def python_only(monkeypatch, tmp_path):
    """The loader forced to fail: no compiler at the build, an empty build
    directory; restored after the test."""
    monkeypatch.setattr(wp, "_lib", None)
    monkeypatch.setattr(wp, "_tried", False)
    monkeypatch.setattr(wp, "_BUILD_DIR", tmp_path / "host")
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    assert wp._load() is None
    return tmp_path / "host"


@pytest.mark.parametrize("name", list(CASES))
def test_native_plan_equals_the_numpy_preps(native, name):
    d = CASES[name]()
    want_pair, want_quad = REACHES.get(name, (None, None))
    if want_pair:
        assert _reached(pair.pair_plan, d, wp.PAIR_ESC_FRAC) == want_pair
    if want_quad:
        assert _reached(quad.quad_plan, d, wp.QUAD_ESC_FRAC) == want_quad
    before = dict(wp.counts)
    plan = wp.WirePlan(d)
    for tlog in (0, 9, 11):
        assert _equal(plan.pair(tlog), pair.prep_pair_group(d, tlog)), tlog
        assert _equal(plan.quad(tlog), quad.prep_quad_group(d, tlog)), tlog
    assert np.array_equal(plan.byte_counts, np.bincount(d, minlength=256))
    assert plan.byte_counts.dtype == np.int64
    assert wp.counts == {"native": before["native"] + 1,
                         "python": before["python"]}
    for kw in (dict(quad=False), dict(pair=False)):   # one wire asked for
        one = wp.WirePlan(d, **kw)
        assert np.array_equal(one.byte_counts, plan.byte_counts)
        if kw.get("quad", True):
            assert _equal(one.quad(), quad.prep_quad_group(d))
        else:
            assert _equal(one.pair(), pair.prep_pair_group(d))


@pytest.mark.parametrize("name", ["p80", "p14", "p80_1MiB", "pairs_257",
                                  "quad_tie_at_255", "len9001"])
def test_pick_with_the_plans_byte_counts(native, name):
    """_pick_wire and _wire_ests read the same counts from the plan as they
    count themselves (and as the JAX package's pick)."""
    d = CASES[name]()
    prep = api.prep_group(d, 10)
    assert prep is not None
    plan = wp.WirePlan(d)
    pp, qp = plan.pair(), plan.quad()
    for modes in ((-1, -1), (-1, 0), (0, -1), (1, 0), (0, 1), (1, 1)):
        assert (api._pick_wire(d, prep, 10, pp, qp, *modes, plan.byte_counts)
                == api._pick_wire(d, prep, 10, pp, qp, *modes)
                == j_api._pick_wire(d, prep, 10, j_prep_pair(d), j_prep_quad(d),
                                    *modes))
    for args in ((pp, qp), (pp, None), (None, qp), (None, None)):
        assert (api._wire_ests(d, prep, 10, *args, plan.byte_counts)
                == api._wire_ests(d, prep, 10, *args))


def test_escape_fractions_are_the_preps_defaults():
    import inspect

    for fn, frac in ((pair.prep_pair_group, wp.PAIR_ESC_FRAC),
                     (quad.prep_quad_group, wp.QUAD_ESC_FRAC),
                     (pair.pair_plan, wp.PAIR_ESC_FRAC),
                     (quad.quad_plan, wp.QUAD_ESC_FRAC)):
        assert inspect.signature(fn).parameters["max_esc_frac"].default == frac


GROUP = 16384


def _mixed() -> bytes:
    """16 KiB groups: pair (Proba80 at this size), pair with escapes, byte
    (Proba14, Proba2), raw (noise), RLE, quad with escapes, pair, a
    9001-byte tail (Proba90: pair)."""
    rng = np.random.default_rng(3)
    parts = [generate_proba(80, GROUP),
             _alphabet(257, np.uint16).tobytes()[:GROUP].ljust(GROUP, b"\1"),
             generate_proba(14, GROUP), generate_proba(2, GROUP),
             bytes(rng.integers(0, 256, GROUP, dtype=np.uint8)), b"\5" * GROUP,
             _escapes(np.uint32, GROUP // 4, 30).tobytes(), _tie(np.uint16).tobytes()[:GROUP],
             generate_proba(90, 9001)]
    return b"".join(parts)


def _planned_groups(data: bytes) -> int:
    """Groups that reach the wire plan: neither RLE nor raw by their bytes."""
    src = np.frombuffer(data, np.uint8)
    return sum(api.prep_group(src[i:i + GROUP], 10) is not None
               for i in range(0, len(src), GROUP))


def _jax_frames(data: bytes) -> bytes:
    """The JAX package's frames for the default flags, from its own pick
    and numpy twins."""
    out = []
    for i in range(0, len(data), GROUP):
        ch = np.frombuffer(data[i:i + GROUP], np.uint8)
        prep = j_api._prep_group(ch, 10)
        if prep is None:
            out.append(j_twin(ch.tobytes()))
            continue
        wire = j_api._pick_wire(ch, prep, 10, j_prep_pair(ch), j_prep_quad(ch),
                                -1, -1)
        twin = {"quad": j_quad_twin, "pair": j_pair_twin, "byte": j_twin}[wire]
        frame = twin(ch.tobytes())
        out.append(j_twin(ch.tobytes()) if frame is None else frame)
    return b"".join(out)


KWS = [{}, dict(pair=1), dict(quad=1), dict(pair=0), dict(quad=0),
       dict(steptots=False, pair=1), dict(quad_table_log=9, pair_table_log=11)]


@pytest.mark.parametrize("kw", KWS, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()) or "default")
def test_frames_equal_with_the_library_and_without(request, native, kw):
    """plan_encode's groups (on _map's threads: several at once) give the
    frames with the native plan that the numpy preps give."""
    data = _mixed()
    before = dict(wp.counts)
    got = api.turbo_compress_device(data, GROUP, device="cpu", **kw)
    wires = api.mode_flags(kw.get("table_log", 0), kw.get("steptots", True),
                           False, kw.get("pair", -1), kw.get("quad", -1))[1:]
    planned = _planned_groups(data) if wires != (0, 0) else 0
    assert wp.counts == {"native": before["native"] + planned,
                         "python": before["python"]}
    if not kw:
        assert got == _jax_frames(data)
    request.getfixturevalue("python_only")
    before = dict(wp.counts)
    assert api.turbo_compress_device(data, GROUP, device="cpu", **kw) == got
    assert wp.counts == {"native": before["native"],
                         "python": before["python"] + planned}
    assert api.turbo_decompress_device(got, device="cpu") == data


def test_plan_encode_batches_unchanged(native, monkeypatch):
    """The encode batches (wire, padded size, tableLog; each group's ids,
    norm and sections) equal those of the numpy preps."""
    data = _mixed()
    got = api.plan_encode(data, GROUP, 10)
    monkeypatch.setattr(wp, "_lib", None)
    monkeypatch.setattr(wp, "_tried", True)
    want = api.plan_encode(data, GROUP, 10)
    assert got[:2] == want[:2] and got[2].keys() == want[2].keys()
    for key in want[2]:
        for (gi, ch, p), (wgi, wch, wp_) in zip(got[2][key], want[2][key]):
            assert gi == wgi and np.array_equal(ch, wch) and _equal(p, wp_)
    assert {k[0] for k in want[2]} == {"byte", "pair", "quad"}


def test_fallback_counts_python_and_builds_nothing(python_only):
    d = _p80(65536)
    before = dict(wp.counts)
    plan = wp.WirePlan(d)
    assert _equal(plan.quad(), quad.prep_quad_group(d))
    assert _equal(plan.pair(), pair.prep_pair_group(d))
    assert plan.byte_counts is None
    assert wp.counts == {"native": before["native"],
                         "python": before["python"] + 1}
    assert not list(python_only.glob("*.so")) and not list(python_only.glob("*.tmp"))


_BUILDER = r"""
import sys
from pathlib import Path
import numpy as np
import finitestateentropy_tpu_torch.turbo.wire_plan as wp
wp._BUILD_DIR = Path(sys.argv[1])
assert wp._load() is not None
plan = wp.WirePlan(np.frombuffer(b"abcd" * 300 + b"abce", np.uint8))
print(plan.quad()["quads"].tolist(), wp.counts)
"""


def test_concurrent_builds_share_one_library(native, tmp_path):
    """Six processes asking for the library in an empty build directory at
    once: one builds under the lock, every one loads the same file."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, [e for _o, e in outs]
    want = f"{[0x64636261, 0x65636261]} {{'native': 1, 'python': 0}}"
    assert {o.strip() for o, _e in outs} == {want}
    assert len(list(tmp_path.glob("libwire_plan_host-*.so"))) == 1
    assert not list(tmp_path.glob("*.tmp"))


def test_threads_share_the_first_load_and_the_counts(native, monkeypatch):
    """Sixteen threads planning from a cold loader: every plan is native and
    equal to the numpy preps, and each one is counted."""
    import threading
    import time

    monkeypatch.setattr(wp, "_lib", None)
    monkeypatch.setattr(wp, "_tried", False)
    path_of = wp._library_path
    # a slow first load: threads arriving meanwhile wait for it
    monkeypatch.setattr(wp, "_library_path", lambda cc: time.sleep(0.2) or path_of(cc))
    datas = [CASES[name]() for name in ("p80", "pairs_257", "quad_tie_at_255", "len9001")]
    wants = [(pair.prep_pair_group(d), quad.prep_quad_group(d)) for d in datas]
    before = dict(wp.counts)
    bad, interval = [], sys.getswitchinterval()

    def work(k):
        for i in range(20):
            j = (k + i) % len(datas)
            plan = wp.WirePlan(datas[j])
            if not (_equal(plan.pair(), wants[j][0]) and _equal(plan.quad(), wants[j][1])):
                bad.append((k, i))

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert bad == []
    assert wp.counts == {"native": before["native"] + 320, "python": before["python"]}


def test_a_wire_not_planned_raises():
    plan = wp.WirePlan(_p80(4096), pair=False)
    with pytest.raises(ValueError, match="pair wire was not planned"):
        plan.pair()
    with pytest.raises(ValueError, match="quad wire was not planned"):
        wp.WirePlan(_p80(4096), quad=False).quad()
