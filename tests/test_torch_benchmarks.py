"""The port's bench (finitestateentropy_tpu_torch/benchmarks/) against the
JAX package's.

fullbench: the host stages have JAX's numbers, names and payloads, and each
returns what JAX's returns; each turbo stage, built on the CPU at one
small group, returns what the JAX function the stage calls returns on the
stage's own inputs (JAX in interpret mode: the call of JAX's fullbench
with interpret=True), and each compat stage what the JAX codec returns on
the stage's blocks.  The windowed decodes need t4 a multiple of S: 256
KiB groups for stages 206 and 208, 512 KiB for 209.  main prints JAX's
lines, and refuses the device stages without CUDA unless asked for the
CPU.  blockbench: the host mode equals JAX's, the cuda and turbo modes
(here on the CPU) report the ratio of the port's own frames; the CLI's
-b prints JAX's lines.  The JAX package is imported inside the tests: the
GPU machine has no jax, and its GPU test collects this file.
"""
import dataclasses
import enum
import re

import numpy as np
import pytest
import torch

from finitestateentropy_tpu_torch.benchmarks import blockbench as bb
from finitestateentropy_tpu_torch.benchmarks import fullbench as fb
from finitestateentropy_tpu_torch.cli import main as cli_main
from finitestateentropy_tpu_torch.turbo import rans_kernels as rk
from finitestateentropy_tpu_torch.turbo.api import turbo_compress_device
from finitestateentropy_tpu_torch.utils import generate_proba

HOST_STAGES = (1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 12, 13, 14, 20, 21, 22, 23,
               25, 30, 31, 32, 33, 40, 41, 42, 45, 46, 50, 51, 52, 55, 56,
               70, 80, 81, 82)
# stage -> (the group size it is built at here, its kernel key on CUDA)
TURBO_STAGES = {200: (1 << 16, "rans_encode2_flat:byte"),
                201: (1 << 16, "rans_decode:byte"),
                204: (1 << 16, "rans_decode_v2:byte"),
                205: (1 << 16, "rans_encode:byte"),
                206: (1 << 18, "rans_decode_w:byte"),
                207: (1 << 16, "rans_encode2:byte"),
                208: (1 << 18, "rans_decode_w:pair"),
                209: (1 << 19, "rans_decode_w:quad"),
                215: (1 << 18, "rans_encode2:quad")}
COMPAT_STAGES = {210: "fse_encode", 211: "fse_decode", 212: "huf_encode_4x",
                 213: "huf_decode_4x:x1", 214: "huf_decode_4x:x2"}
ENCODES = {200: True, 207: True, 215: True, 205: False}   # packed words?
# fullbench's line: f"{num:3d} {name:38s} {rate:10.1f} MB/s"
LINE = re.compile(r"^((\s*\d+) .+ )[ \d.]{10} MB/s$")


def _same(a, b) -> bool:
    """Deep equality of two packages' results: tuples, arrays, bytes,
    enums by name, dataclasses (CTable, BlockResult, ...) field by field."""
    if isinstance(a, enum.Enum):
        return isinstance(b, enum.Enum) and a.name == b.name
    if dataclasses.is_dataclass(a):
        return (type(a).__name__ == type(b).__name__
                and _same(tuple(vars(a).values()), tuple(vars(b).values())))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    return a == b


def _closure(fn) -> dict:
    """The values a stage's lambda closes over, by name: the stage's
    inputs as the stage function made them."""
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__ or ())))


@pytest.fixture(scope="module")
def host_stages():
    from finitestateentropy_tpu.benchmarks import fullbench as j_fb

    return j_fb._stages(), fb._stages()


def test_host_stage_table_equals_jax(host_stages):
    js, ps = host_stages
    assert tuple(sorted(js)) == tuple(sorted(ps)) == HOST_STAGES
    for num in HOST_STAGES:
        assert ps[num][0] == js[num][0] and ps[num][2] == js[num][2] == 65536
        assert len(ps[num]) == len(js[num]) == 3


@pytest.mark.parametrize("num", HOST_STAGES)
def test_host_stage_returns_jax_result(host_stages, num):
    js, ps = host_stages
    assert _same(ps[num][1](), js[num][1]())


@pytest.fixture(scope="module")
def turbo_stages():
    """The port's turbo stages on the CPU at each size TURBO_STAGES uses,
    one group each."""
    out = {}
    for size in sorted({s for s, _k in TURBO_STAGES.values()}):
        st = fb._turbo_stages(1, size, "cpu")
        for num, (s, _k) in TURBO_STAGES.items():
            if s == size:
                out[num] = st[num]
    return out


def _jax_call(num: int, args: dict):
    """The JAX function stage num calls, as JAX's fullbench calls it but
    with interpret=True, on the port stage's inputs."""
    import jax.numpy as jnp

    from finitestateentropy_tpu.turbo import rans_kernels as j

    a = {k: (tuple(jnp.asarray(t.numpy()) for t in v) if isinstance(v, tuple)
             else jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v)
         for k, v in args.items()}
    calls = {
        200: lambda: j.rans_encode2(a["fcb"], a["mgb"], a["srcw"], a["t4"],
                                    a["hcap"], True),
        205: lambda: j.rans_encode(a["fcb"], a["mgb"], a["srcw"], a["t4"],
                                   a["hcap"], True),
        201: lambda: j.rans_decode(*a["dargs"], a["t4"], a["hrows"], True),
        204: lambda: j.rans_decode_v2(*a["dargs2"], a["t4"], a["hrows"], True),
        206: lambda: j.rans_decode_w(*a["dargs2"], a["t4"], a["hrows"], 8, 11,
                                     64, True),
        207: lambda: j.rans_encode2(a["fcb"], a["mgb"], a["srcw"], a["t4"],
                                    a["hcap"], True, False, 11, True, 0, True),
        208: lambda: j.rans_decode_w(*a["dp"], a["t2"], a["hrows"], 8, a["tl"],
                                     64, True, True, False, True),
        209: lambda: j.rans_decode_w(*a["dq"], a["steps"], a["qhrows"], 8,
                                     a["qtl"], 128, True, False, False, False,
                                     True),
        215: lambda: j.rans_encode2(*a["qea"], a["steps"], a["qhcap"], True,
                                    False, a["qtl"], True, 0, True, True),
    }
    return [None if x is None else np.asarray(x) for x in calls[num]()]


@pytest.mark.parametrize("num", list(TURBO_STAGES))
def test_turbo_stage_returns_jax_interpret_result(turbo_stages, num):
    name, fn, payload, kind = turbo_stages[num]
    assert kind == "device" and payload == TURBO_STAGES[num][0]
    args = _closure(fn)
    got = [None if x is None else x.numpy() for x in fn()]
    want = _jax_call(num, args)
    if num in ENCODES:              # stream, finals, csize, stots
        cs = int(want[2][0])
        assert int(got[2][0]) == cs > 0
        hw = "<u2" if ENCODES[num] else "<i4"
        # the payload is the first csize halfwords; JAX leaves the rest
        # unwritten
        assert np.array_equal(got[0].reshape(-1).view(hw)[:cs],
                              want[0].reshape(-1).view(hw)[:cs])
        assert np.array_equal(got[1], want[1]) and np.array_equal(got[3], want[3])
    else:                           # out, err
        assert got[1].tolist() == [0] and np.asarray(want[1]).reshape(-1).tolist() == [0]
        assert np.array_equal(got[0], want[0])


def test_turbo_host_stages_equal_jax():
    """Stages 202 (the decode table pack) and 203 (the group prep) at one
    64 KiB group: JAX's _prep_group and pack_rans_dtable on its input."""
    from finitestateentropy_tpu.turbo.api import _prep_group as j_prep
    from finitestateentropy_tpu.turbo.rans_kernels import pack_rans_dtable

    st = fb._turbo_stages(1, 1 << 16, "cpu")
    src = _closure(st[203][1])["src"]
    base = generate_proba(20)
    assert src.tobytes() == (base * 2)[: 1 << 16]
    want = j_prep(src)
    assert _same(st[203][1](), want)
    assert _same(st[202][1](), pack_rans_dtable(want[0]))
    assert st[202][2] == st[203][2] == 1 << 16


@pytest.fixture(scope="module")
def compat_stages():
    return fb._device_compat_stages(blocks=2, block_size=4096, device="cpu")


@pytest.mark.parametrize("num", list(COMPAT_STAGES))
def test_compat_stage_returns_jax_codec_result(compat_stages, num):
    from finitestateentropy_tpu.models.fse_codec import FseTpuCodec
    from finitestateentropy_tpu.models.huf_codec import HufTpuCodec

    name, fn, payload = compat_stages[num]
    args = _closure(fn)
    codec = (FseTpuCodec(block_size=4096) if num < 212
             else HufTpuCodec(block_size=4096, decoder="x2" if num == 214 else "x1"))
    if num in (210, 212):
        blocks = args["blocks"]
        assert b"".join(blocks) == generate_proba(20, 8192) and len(blocks) == 2
        assert payload == 8192
        want = codec.compress_blocks(blocks)
    else:
        items = args["fitems" if num == 211 else "hitems"]
        assert len(items) == 2 and payload == 8192
        want = codec.decompress_blocks(items)
    assert _same(fn(), want)


def test_compat_stage_names_equal_jax(compat_stages):
    import inspect

    from finitestateentropy_tpu.benchmarks import fullbench as j_fb

    src = inspect.getsource(j_fb._device_compat_stages)
    for num, (name, _fn, _p) in compat_stages.items():
        assert f'{num}: ("{name}"' in src


def _lines(text: str) -> list[tuple[str, str]]:
    """(the line up to its rate's field, the stage number) of each line."""
    out = []
    for line in text.strip("\n").splitlines():
        m = LINE.match(line)
        assert m, line
        out.append((m.group(1), m.group(2).strip()))
    return out


def test_main_prints_jax_lines(capsys):
    from finitestateentropy_tpu.benchmarks import fullbench as j_fb

    assert fb.main(["1", "9"]) == 0
    ours = capsys.readouterr().out
    assert j_fb.main(["1", "9"]) == 0
    theirs = capsys.readouterr().out
    assert _lines(ours) == _lines(theirs) == [
        (f"  1 {'HIST_count(255)':38s} ", "1"), (f"  9 {'FSE_compress':38s} ", "9")]


def test_main_device_stages_need_cuda_or_cpu(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["200"], ["1", "214"], [], ["--device", "cuda", "215"]):
        assert fb.main(argv) == 1
        assert "--device cpu" in capsys.readouterr().err
    assert fb.main(["--device", "cpu", "2"]) == 0
    assert _lines(capsys.readouterr().out)[0][1] == "2"


def _files(tmp_path):
    paths = []
    for name, p, n in (("a.bin", 80, 40000), ("b.bin", 14, 70000)):
        f = tmp_path / name
        f.write_bytes(generate_proba(p, n))
        paths.append(str(f))
    return paths


@pytest.mark.parametrize("codec", ["fse", "huf"])
def test_bench_host_equals_jax(tmp_path, codec):
    from finitestateentropy_tpu.benchmarks import blockbench as j_bb

    for path in _files(tmp_path):
        data = open(path, "rb").read()
        assert (bb._bench_host(data, codec, 1, 8192)[0]
                == j_bb._bench_host(data, codec, 1, 8192)[0])


def _ratios(err: str) -> list[str]:
    return re.findall(r"ratio +([\d.]+) ", err)


@pytest.fixture
def on_cpu(monkeypatch):
    """The cuda and turbo modes on the CPU: the codecs and the entry points
    called with device="cpu" (the plain versions of the kernels)."""
    import finitestateentropy_tpu_torch.models as models
    from finitestateentropy_tpu_torch.turbo import api

    codec, comp, decomp = (models.get_batch_codec, api.turbo_compress_device,
                           api.turbo_decompress_device)
    monkeypatch.setattr(models, "get_batch_codec",
                        lambda c, block_size: codec(c, block_size=block_size,
                                                    device="cpu"))
    monkeypatch.setattr(api, "turbo_compress_device",
                        lambda d, group_size: comp(d, group_size, device="cpu"))
    monkeypatch.setattr(api, "turbo_decompress_device",
                        lambda b: decomp(b, device="cpu"))


@pytest.mark.parametrize("codec", ["fse", "huf"])
def test_bench_files_cuda_mode_on_cpu_reports_the_frames_ratio(tmp_path, capsys,
                                                               on_cpu, codec):
    """The compat codecs' payloads are the twin's: the cuda mode (on the
    CPU) reports the host mode's ratio."""
    paths = _files(tmp_path)
    assert bb.bench_files(paths, codec, 1, 8192, "host") == 0
    host = _ratios(capsys.readouterr().err)
    assert bb.bench_files(paths, codec, 1, 8192, "cuda") == 0
    assert _ratios(capsys.readouterr().err) == host and len(host) == 2


def test_bench_files_turbo_mode_on_cpu_reports_the_frames_ratio(tmp_path, capsys,
                                                                on_cpu):
    paths = _files(tmp_path)
    assert bb.bench_files(paths, iters=1, device="turbo") == 0
    want = []
    for path in paths:
        data = open(path, "rb").read()
        blob = turbo_compress_device(data, 1 << 20, device="cpu")
        want.append(f"{len(data) / len(blob):.3f}")
    err = capsys.readouterr().err
    assert _ratios(err) == want and err.count("turboRANS") == 2


def test_bench_files_rejects_unknown_modes(tmp_path):
    with pytest.raises(ValueError, match="host, cuda or turbo"):
        bb.bench_files(_files(tmp_path), device="tpu")


def _mask(err: str) -> list[str]:
    return [re.sub(r"[\d.]+ MB/s", "MB/s", line) for line in err.strip().splitlines()]


def test_cli_bench_host_prints_jax_lines(tmp_path, capsys):
    from finitestateentropy_tpu.cli import main as j_main

    paths = _files(tmp_path)
    assert cli_main(["-b", "--device", "host", "-i1", "-B8K", *paths]) == 0
    ours = capsys.readouterr().err
    assert j_main(["-b", "-i1", "-B8K", *paths]) == 0
    theirs = capsys.readouterr().err
    assert _mask(ours) == _mask(theirs) and len(_mask(ours)) == 2


def test_cli_bench_needs_cuda_or_host(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    paths = _files(tmp_path)
    for argv in (["-b", *paths], ["-b", "-T", paths[0]], ["-b", "-h", "-i1", paths[0]]):
        assert cli_main(argv) == 1
        assert "--device host" in capsys.readouterr().err


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the GPU)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_stages_launch_their_kernels_and_match_interpret(cuda):
    """Each device stage launches its kernel, and its output equals the
    same call's with interpret=True."""
    for num, (size, key) in TURBO_STAGES.items():
        st = fb._turbo_stages(2, size, cuda)[num][1]
        rk.reset_launches()
        got = st()
        torch.cuda.synchronize()
        assert {k: v for k, v in rk.launches.items() if v} == {key: 1}, num
        want = st(True)
        assert {k: v for k, v in rk.launches.items() if v} == {key: 1}, num
        if num in ENCODES:
            cs = int(want[2][0])
            hw = torch.int16 if ENCODES[num] else torch.int32
            assert torch.equal(got[2], want[2])
            assert torch.equal(got[0][0].reshape(-1).view(hw)[:cs],
                               want[0][0].reshape(-1).view(hw)[:cs])
        else:
            assert not got[1].any() and torch.equal(got[0], want[0])
    st = fb._device_compat_stages(blocks=4, block_size=32768, device=cuda)
    for num, key in COMPAT_STAGES.items():
        rk.reset_launches()
        st[num][1]()
        torch.cuda.synchronize()
        assert {k: v for k, v in rk.launches.items() if v} == {key: 1}, num
