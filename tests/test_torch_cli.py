"""The port's CLI (finitestateentropy_tpu_torch/cli.py) and its copy of the
resumable job layer (io/jobs.py).

`-T --device host` writes the same .tfse bytes as the JAX package's CLI
`-T` with the same flags on a machine without an accelerator (both run
the native host codec when it is built), and each CLI decodes the
other's files.  The compat half (`-e`, `-h`, `--auto`, `-z`, `-d`) with
`--device host` writes the .fse bytes the JAX CLI writes with its
default `--device host` (the host twins), and the device path (here the
codecs on the CPU, CUDA faked) writes the same frames at the frame's
block size.  Without CUDA and without `--device host`, `-T` and the
compat codecs exit 1.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from finitestateentropy_tpu_torch import native
from finitestateentropy_tpu_torch.cli import main
from finitestateentropy_tpu_torch.io import jobs
from finitestateentropy_tpu_torch.turbo.api import (turbo_compress_device,
                                                    turbo_decompress_device)
from finitestateentropy_tpu_torch.utils import generate_proba

FLAGS = {"default": [], "ratio": ["--ratio"], "tlog9": ["-M", "9"],
         "group64k": ["-G", "64K"], "totals": ["--sect", "totals"]}


@pytest.fixture(scope="module")
def have_native():
    if not native.available():
        pytest.skip("native/libturbofse.so could not be built")


def _src(tmp_path, data: bytes, name: str = "in.bin"):
    p = tmp_path / name
    p.write_bytes(data)
    return str(p)


@pytest.mark.parametrize("flags", list(FLAGS))
def test_cli_host_frames_equal_jax_cli(tmp_path, have_native, flags):
    from finitestateentropy_tpu.cli import main as j_main

    data = generate_proba(80)[:300000]
    src = _src(tmp_path, data)
    ours, theirs = str(tmp_path / "p.tfse"), str(tmp_path / "j.tfse")
    assert main(["-T", "--device", "host", "-f", *FLAGS[flags], src, ours]) == 0
    assert j_main(["-T", "-f", *FLAGS[flags], src, theirs]) == 0
    blob = (tmp_path / "p.tfse").read_bytes()
    assert blob == (tmp_path / "j.tfse").read_bytes()
    # each CLI decodes the other's file
    assert main(["-T", "--device", "host", "-d", "-f", theirs,
                 str(tmp_path / "p.out")]) == 0
    assert j_main(["-T", "-d", "-f", ours, str(tmp_path / "j.out")]) == 0
    assert (tmp_path / "p.out").read_bytes() == data
    assert (tmp_path / "j.out").read_bytes() == data


def test_cli_host_without_native_runs_entry_points_on_cpu(tmp_path, monkeypatch):
    """--device host with no native library: the entry points on the CPU
    (default flags: the auto wire pick), as the JAX CLI falls back."""
    monkeypatch.setattr(native, "available", lambda: False)
    data = generate_proba(80)[:3 * 16384 + 500]
    src = _src(tmp_path, data)
    assert main(["-T", "--device", "host", "-G", "16K", src]) == 0
    blob = (tmp_path / "in.bin.tfse").read_bytes()
    assert blob == turbo_compress_device(data, 16384, device="cpu")
    assert main(["-T", "--device", "host", "-d", "-f", src + ".tfse",
                 str(tmp_path / "back")]) == 0
    assert (tmp_path / "back").read_bytes() == data
    assert main(["-T", "--device", "host", "-t", src + ".tfse"]) == 0


def test_cli_turbo_needs_cuda_or_device_host(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = _src(tmp_path, generate_proba(80)[:5000])
    for extra in ([], ["--device", "cuda"], ["-d"]):
        assert main(["-T", *extra, src]) == 1
        assert "--device host" in capsys.readouterr().err
    assert not (tmp_path / "in.bin.tfse").exists()


def test_cli_unported_modes_and_argument_checks(tmp_path, capsys, monkeypatch):
    """-b and the compat codecs need CUDA or --device host; -z has no
    device codec."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = _src(tmp_path, generate_proba(80)[:5000])
    for argv in (["-e", src], ["-h", src], [src], ["--auto", src],
                 ["-d", src], ["-e", "--device", "cuda", src]):
        assert main(argv) == 1
        assert "--device host" in capsys.readouterr().err
    assert main(["-z", src]) == 1
    assert "-z (zlibh) has no device codec" in capsys.readouterr().err
    assert not (tmp_path / "in.bin.fse").exists()
    for argv in (["-b", src], ["-b", "-T", src], ["-b", "-h", src]):
        assert main(argv) == 1
        assert "--device host" in capsys.readouterr().err
    assert main(["-T", "--device", "host"]) == 1          # no input
    assert main(["-T", "--device", "host", src, "a", "b"]) == 1   # file list
    with pytest.raises(SystemExit):
        main(["-T", "--device", "tpu", src])               # not a choice here


COMPAT = {"fse": ["-e"], "huf": ["-h"], "auto": ["--auto"], "zlibh": ["-z"],
          "fse_64k": ["-e", "-B", "64K"], "huf_4k": ["-h", "-B", "4K"]}


def _compat_data() -> bytes:
    """Proba80 and Proba14 with a run of one byte and a ragged tail."""
    return (generate_proba(80)[:40000] + b"\x33" * 20000
            + generate_proba(14)[:30000] + generate_proba(80)[:555])


@pytest.mark.parametrize("flags", list(COMPAT))
def test_cli_compat_host_frames_equal_jax_cli(tmp_path, flags):
    """--device host writes the JAX CLI's bytes (its default device is the
    host); each CLI decodes the other's file, by the frame's magic."""
    from finitestateentropy_tpu.cli import main as j_main

    data = _compat_data()
    src = _src(tmp_path, data)
    ours, theirs = str(tmp_path / "p.fse"), str(tmp_path / "j.fse")
    assert main([*COMPAT[flags], "--device", "host", "-f", src, ours]) == 0
    assert j_main([*COMPAT[flags], "-f", src, theirs]) == 0
    blob = (tmp_path / "p.fse").read_bytes()
    assert blob == (tmp_path / "j.fse").read_bytes()
    assert main(["-d", "--device", "host", "-f", theirs, str(tmp_path / "p.out")]) == 0
    assert j_main(["-d", "-f", ours, str(tmp_path / "j.out")]) == 0
    assert (tmp_path / "p.out").read_bytes() == data
    assert (tmp_path / "j.out").read_bytes() == data
    assert main(["-t", "--device", "host", ours]) == 0


@pytest.fixture
def cpu_codecs(monkeypatch):
    """The CLI's device path on the CPU: CUDA faked present, the codecs
    built with device="cpu" (their plain versions); records each codec's
    block size."""
    import finitestateentropy_tpu_torch.models as models

    built = []
    real = models.get_batch_codec

    def on_cpu(codec, mesh=0, block_size=32768, device=None):
        built.append((codec, block_size))
        return real(codec, mesh, block_size, device="cpu")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(models, "get_batch_codec", on_cpu)
    return built


@pytest.mark.parametrize("flags", ["fse", "huf", "auto"])
def test_cli_compat_device_path_writes_twin_frames(tmp_path, cpu_codecs, flags):
    """-e / -h / --auto through the device codecs at 8 KiB blocks write the
    host twin's frames; -d decodes them by the magic through the device
    codec named there (at the frame's block size)."""
    data = _compat_data()[:30000]
    src = _src(tmp_path, data)
    dst, host = str(tmp_path / "d.fse"), str(tmp_path / "h.fse")
    argv = [*COMPAT[flags], "-B", "8K", "-f"]
    assert main([*argv, src, dst]) == 0
    assert main([*argv, "--device", "host", src, host]) == 0
    assert (tmp_path / "d.fse").read_bytes() == (tmp_path / "h.fse").read_bytes()
    assert main(["-d", "-f", dst, str(tmp_path / "back")]) == 0
    assert (tmp_path / "back").read_bytes() == data
    want = "huf" if flags == "huf" else "fse"
    assert cpu_codecs[-1] == (want, 8192)
    assert all(bs == 8192 for _c, bs in cpu_codecs)


def test_cli_compat_zlibh_frames_decode_through_the_twin(tmp_path, cpu_codecs):
    """zlibh frames decode through the twin on the device path too; -z
    still needs --device host to compress."""
    data = _compat_data()[:20000]
    src = _src(tmp_path, data)
    assert main(["-z", "-f", src]) == 1
    assert main(["-z", "--device", "host", "-f", src]) == 0
    assert main(["-d", "-f", src + ".fse", str(tmp_path / "back")]) == 0
    assert (tmp_path / "back").read_bytes() == data
    assert cpu_codecs == []


def test_cli_refuses_overwrite_without_force(tmp_path, have_native):
    src = _src(tmp_path, generate_proba(70)[:10000])
    dst = tmp_path / "x.tfse"
    dst.write_bytes(b"existing")
    assert main(["-T", "--device", "host", src, str(dst)]) == 1
    assert dst.read_bytes() == b"existing"
    assert main(["-T", "--device", "host", "-f", src, str(dst)]) == 0
    assert dst.read_bytes() != b"existing"


def test_cli_stdin_stdout_pipes(have_native):
    data = generate_proba(70)[:50000]
    cmd = [sys.executable, "-m", "finitestateentropy_tpu_torch.cli", "-T",
           "--device", "host"]
    r = subprocess.run(cmd + ["-", "-"], input=data, capture_output=True,
                       check=True, timeout=120)
    assert r.stdout == native.rans_compress2_native(data)
    r2 = subprocess.run(cmd + ["-d", "-", "-"], input=r.stdout,
                        capture_output=True, check=True, timeout=120)
    assert r2.stdout == data


# ---------------------------------------------------------------------------
# native.py: the build never leaves a half-written library in place
# ---------------------------------------------------------------------------


@pytest.fixture
def native_dir(tmp_path, monkeypatch):
    """native.py pointed at a scratch copy of the native directory, with the
    loader's cached state reset."""
    for name in ("build.sh", "turbofse.cc"):
        (tmp_path / name).write_text("stub")
    monkeypatch.setattr(native, "_LIB_DIR", tmp_path)
    monkeypatch.setattr(native, "_LIB", tmp_path / "libturbofse.so")
    monkeypatch.setattr(native, "_LOCK", tmp_path / "libturbofse.lock")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    return tmp_path


def test_native_build_replaces_the_library_whole(native_dir, monkeypatch):
    """The build runs in a temporary directory and moves the finished file
    into place; a failed build leaves the old file and no temporary."""
    def build(cmd, check, capture_output):
        (Path(cmd[1]).parent / "libturbofse.so").write_bytes(b"new")
        assert not (native_dir / "libturbofse.so").exists() or \
            (native_dir / "libturbofse.so").read_bytes() == b"old"

    (native_dir / "libturbofse.so").write_bytes(b"old")
    monkeypatch.setattr(native.subprocess, "run", build)
    native._build()
    assert (native_dir / "libturbofse.so").read_bytes() == b"new"

    def fail(cmd, check, capture_output):
        raise subprocess.CalledProcessError(1, cmd)
    monkeypatch.setattr(native.subprocess, "run", fail)
    with pytest.raises(subprocess.CalledProcessError):
        native._build()
    assert (native_dir / "libturbofse.so").read_bytes() == b"new"
    assert not list(native_dir.glob(".build-*"))


def test_native_load_builds_under_the_lock_once(native_dir, monkeypatch):
    """A library that will not load (missing, stale or half-written) is
    rebuilt once, under the lock; a build that fails leaves available()
    False."""
    from unittest import mock

    built = []
    monkeypatch.setattr(native, "_build", lambda: built.append(native._LOCK.exists()))
    monkeypatch.setattr(native, "_open", lambda: mock.MagicMock() if built else None)
    assert native.available() and built == [True]
    assert native._load() is native._load() and len(built) == 1

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_open", lambda: None)
    assert not native.available() and len(built) == 2


# ---------------------------------------------------------------------------
# io/jobs.py: the port's copy
# ---------------------------------------------------------------------------


def test_jobs_resume_and_verify_equal_jax(tmp_path, have_native):
    from finitestateentropy_tpu.io import jobs as j_jobs

    data = generate_proba(80)[:300000]
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    part = tmp_path / "part.tfse"
    m1 = jobs.compress_file_resumable(src, part, group_size=65536, max_groups=2)
    assert m1.groups_done == 2 and not jobs.job_status(part)["done"]
    jobs.compress_file_resumable(src, part, group_size=65536)
    st = jobs.job_status(part)
    assert st["done"] and st["next_group"] == 5
    full = tmp_path / "jax.tfse"
    j_jobs.compress_file_resumable(src, full, group_size=65536)
    assert part.read_bytes() == full.read_bytes()
    assert st == j_jobs.job_status(full)
    assert jobs.verify_job(part) and j_jobs.verify_job(part)
    assert turbo_decompress_device(part.read_bytes(), device="cpu") == data
    blob = bytearray(part.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    part.write_bytes(bytes(blob))
    with pytest.raises(Exception):
        jobs.verify_job(part)


def test_jobs_verify_default_decoder_without_native(tmp_path, monkeypatch):
    """With no native library the default decoder is the port's
    turbo_decompress_device, which runs on CUDA and raises without it."""
    data = generate_proba(14)[:100000]
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    dst = tmp_path / "out.tfse"
    monkeypatch.setattr(native, "available", lambda: False)
    m = jobs.compress_file_resumable(src, dst, group_size=65536)  # numpy twin
    assert m.groups_done == 2 and m.as_dict()["bytes_in"] == len(data)
    if torch.cuda.is_available():
        assert jobs.verify_job(dst)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            jobs.verify_job(dst)
    assert jobs.verify_job(dst, decompress=lambda b: turbo_decompress_device(
        b, device="cpu"))
    assert np.frombuffer(dst.read_bytes()[:4], "<u4")[0] == 0x183EF002
