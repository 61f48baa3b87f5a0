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
names = {m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")}
for name in sorted(names):
    importlib.import_module(name)
# the multi-device layer and the v0 codec are among them
assert {pkg.__name__ + "." + m for m in (
    "parallel.mesh", "parallel.turbo_dp", "parallel.distributed",
    "parallel.dryrun", "turbo.kernels", "turbo.format",
    "refimpl.tables")} <= names, sorted(names)
from finitestateentropy_tpu_torch.turbo.api import (turbo_compress_device,
                                                    turbo_decompress_device)
from finitestateentropy_tpu_torch.turbo.rans import rans_compress
from finitestateentropy_tpu_torch.utils import generate_proba
data = generate_proba(80, 40960)
blob = turbo_compress_device(data, group_size=40960, pair=0, quad=0,
                             device="cpu")
assert blob == rans_compress(data)
assert turbo_decompress_device(blob, device="cpu") == data
assert turbo_compress_device(data, group_size=8192, pair=0, quad=0, mesh=2,
                             device="cpu") == rans_compress(data[:8192]) + \
    b"".join(rans_compress(data[i:i + 8192]) for i in range(8192, 40960, 8192))
from finitestateentropy_tpu_torch.turbo import (turbo_fse_compress,
                                                turbo_fse_decompress)
from finitestateentropy_tpu_torch.turbo.format import parse_group
from finitestateentropy_tpu_torch.turbo.kernels import stage_groups, turbo_fse_decode
from finitestateentropy_tpu_torch.turbo.state import to_tensors
v0 = turbo_fse_compress(data)
cs, tbl, init, st, t4, wrows = stage_groups([parse_group(v0)[0]])
ins = to_tensors("cpu", csize_bits=cs, tables=tbl, init_states=init, streams=st)
out, err = turbo_fse_decode(*ins.values(), t4, wrows)
assert err.tolist() == [0] and out[0].numpy().tobytes() == data
assert turbo_fse_decompress(v0) == data
print("ok")
"""


def test_port_imports_and_roundtrips_without_jax():
    r = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def test_sources_import_no_jax_package():
    """No module of the port and no line of chip_smoke.py imports jax or the
    JAX package, by an import statement or by name."""
    bad = re.compile(r"^\s*(import|from)\s+(jax\b|finitestateentropy_tpu\b(?!_torch))"
                     r"|import_module\(\s*[\"'](jax\b|finitestateentropy_tpu\b(?!_torch))",
                     re.M)
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    assert {"mesh.py", "turbo_dp.py", "distributed.py", "dryrun.py",
            "kernels.py", "format.py", "tables.py"} <= {f.name for f in files}
    offenders = [str(f.relative_to(REPO)) for f in files
                 if bad.search(f.read_text())]
    assert offenders == []
