"""run.py refuses to run without the card, and without the program."""
import json
import os
import shutil
import subprocess
import sys

from h100_bench.tests.conftest import BENCH, ROOT


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_no_card_no_result():
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "turbo_speed.p80_1m", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       env=_env(), cwd=ROOT, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_without_the_program_no_result(tmp_path):
    """In a checkout of BENCHMARK.json and h100_bench alone, a run (here
    on the CPU, past the look for a card) fails and prints nothing."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); from h100_bench import harness; "
            "print(harness.run('turbo_speed.p80_1m', 1, 0.1, False, device='cpu'))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=_env(), cwd=tmp_path, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "finitestateentropy_tpu_torch" in p.stderr


def test_benchmark_json_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "h100_bench/run.py"]
    assert len(json.dumps(bench)) < 64 * 1024
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
