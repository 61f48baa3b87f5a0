"""The port stands alone: it imports neither jax nor the JAX package.

tests/conftest.py imports jax into this session, so the import check runs
in a subprocess where both are blocked.
"""
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "finitestateentropy_tpu_torch"

_CHILD = r"""
import sys
sys.modules["jax"] = None                      # any `import jax` now fails
sys.modules["finitestateentropy_tpu"] = None
import pkgutil, importlib
import finitestateentropy_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from finitestateentropy_tpu_torch.turbo.api import (turbo_compress_device,
                                                    turbo_decompress_device)
from finitestateentropy_tpu_torch.turbo.rans import rans_compress
from finitestateentropy_tpu_torch.utils import generate_proba
data = generate_proba(80, 40960)
blob = turbo_compress_device(data, group_size=40960, pair=0, quad=0,
                             device="cpu")
assert blob == rans_compress(data)
assert turbo_decompress_device(blob, device="cpu") == data
print("ok")
"""


def test_port_imports_and_roundtrips_without_jax():
    r = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def test_sources_import_no_jax_package():
    bad = re.compile(r"^\s*(import|from)\s+(jax\b|finitestateentropy_tpu\b(?!_torch))",
                     re.M)
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(REPO)) for f in files
                 if bad.search(f.read_text())]
    assert offenders == []
