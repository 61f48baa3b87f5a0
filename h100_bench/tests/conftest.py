import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda():
    """Skips unless a CUDA device is present (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture(scope="session")
def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    """A copy of the benchmark's folder whose traffic is cut to a few KiB a
    call, so that a whole run takes a second on the CPU."""
    root = tmp_path_factory.mktemp("bench") / "h100_bench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for path in root.glob("traffic/*.json"):
        t = json.loads(path.read_text())
        t.update(call_bytes=6000 if t["pool"] > 4 else 9000,
                 stream_bytes=1 << 17, pool=min(t["pool"], 6))
        path.write_text(json.dumps(t))
    return root
