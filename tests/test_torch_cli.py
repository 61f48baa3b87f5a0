"""The port's CLI (finitestateentropy_tpu_torch/cli.py) and its copy of the
resumable job layer (io/jobs.py).

`-T --device host` writes the same .tfse bytes as the JAX package's CLI
`-T` with the same flags on a machine without an accelerator (both run
the native host codec when it is built), and each CLI decodes the
other's files.  Without CUDA and without `--device host`, `-T` exits 1.
"""
import subprocess
import sys

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


def test_cli_unported_modes_and_argument_checks(tmp_path, capsys):
    src = _src(tmp_path, generate_proba(80)[:5000])
    for argv in (["-e", src], ["-h", src], ["-z", src], [src], ["--auto", src]):
        assert main(argv) == 1
        assert "not yet ported" in capsys.readouterr().err
    assert main(["-b", src]) == 1
    assert "not yet ported" in capsys.readouterr().err
    assert main(["-T", "--device", "host"]) == 1          # no input
    assert main(["-T", "--device", "host", src, "a", "b"]) == 1   # file list
    with pytest.raises(SystemExit):
        main(["-T", "--device", "tpu", src])               # not a choice here


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
