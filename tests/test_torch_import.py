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
# importing every module built nothing: XXH32's library waits for a first hash
assert not sys.modules[pkg.__name__ + ".utils.xxhash32"]._tried
# the multi-device layer, the v0 codec, the resident pipeline and its
# device ops, the CLI and its host modules, the compat codecs, their ops,
# frame layer, twins and sharded steps are among them
assert {pkg.__name__ + "." + m for m in (
    "parallel.mesh", "parallel.turbo_dp", "parallel.distributed",
    "parallel.dryrun", "turbo.kernels", "turbo.format",
    "refimpl.tables", "ops.hist", "ops.norm", "ops.rans_tables",
    "turbo.device_api", "native", "utils.xxhash32", "io.jobs",
    "cli", "config", "refimpl.bitstream", "refimpl.blocktypes", "refimpl.fse",
    "refimpl.huf", "refimpl.zlibh", "io.frame", "models", "models.select",
    "models.fse_codec", "models.huf_codec", "ops.bitio", "ops.fse_tables",
    "ops.fse_kernels", "ops.huf_kernels", "parallel.dp", "refimpl.fseu16",
    "utils.xxhash64", "models.u16_codec", "benchmarks",
    "benchmarks.fullbench", "benchmarks.blockbench")} <= names, sorted(names)
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
import numpy as np
import torch
from finitestateentropy_tpu_torch.turbo import (rans_compress_resident,
                                                rans_decompress_resident)
x = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
resident = rans_compress_resident(x, 40960)
assert resident == blob
assert rans_decompress_resident(resident, device="cpu").numpy().tobytes() == data
# the compat codecs on the CPU: frames equal the host twin's
from finitestateentropy_tpu_torch.io import frame as fio
from finitestateentropy_tpu_torch.models import get_batch_codec
for codec in ("fse", "huf"):
    comp, dec = get_batch_codec(codec, block_size=4096, device="cpu")
    fr = fio.compress_bytes(data[:9000], codec, 2, comp)
    assert fr == fio.compress_bytes(data[:9000], codec, 2)
    assert fio.decompress_bytes(fr, dec) == data[:9000]
# the U16 stream codec (compat and turbo wires) and XXH64, by the JAX
# package's package-level names
from finitestateentropy_tpu_torch import CodecConfig, HUF_TABLELOG_MAX
from finitestateentropy_tpu_torch.models import U16Codec
from finitestateentropy_tpu_torch.refimpl import fse_compress_u16, fse_decompress_u16
from finitestateentropy_tpu_torch.utils import xxh32, xxh64
assert CodecConfig().block_size == 32768 and HUF_TABLELOG_MAX == 12
assert xxh64(b"") == 0xEF46DB3751D8E999 and xxh32(b"") == 0x02CC5D05
sym = (np.frombuffer(data[:6000], np.uint8).astype(np.uint16) * 3) % 700
r = fse_compress_u16(sym, max_symbol_value=int(sym.max()))
assert np.array_equal(fse_decompress_u16(r.data, len(sym)), sym)
for wire in ("compat", "turbo"):
    c = U16Codec(wire=wire, device="cpu")
    blobs = c.compress_streams([sym])
    assert np.array_equal(c.decompress_streams([(blobs[0], len(sym))])[0], sym)
# the bench: a host stage, and a turbo stage on the CPU
from finitestateentropy_tpu_torch.benchmarks import fullbench
assert fullbench._stages()[1][0] == "HIST_count(255)"
enc = fullbench._turbo_stages(1, 1 << 19, "cpu")[207][1]()
assert int(enc[2][0]) > 0
print("ok")
"""


def test_port_imports_and_roundtrips_without_jax():
    r = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


_XXH_CHILD = r"""
import sys
sys.modules["torch"] = None                    # any `import torch` now fails
import finitestateentropy_tpu_torch.utils.xxhash32 as xxh
assert xxh._lib is None and not xxh._tried     # the import built nothing
assert xxh.xxh32(b"") == 0x02CC5D05            # nor does the hash need torch
assert sum(xxh.counts.values()) == 1
print("ok")
"""


def test_xxhash32_imports_no_torch_and_builds_nothing():
    """utils/xxhash32.py, the frame checksum of the host twins' path, loads
    without torch and builds its native library at the first hash, never at
    import."""
    r = subprocess.run([sys.executable, "-c", _XXH_CHILD], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
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
            "kernels.py", "format.py", "tables.py", "device_api.py",
            "rans_tables.py", "native.py", "xxhash32.py", "jobs.py",
            "cli.py", "bitio.py", "fse_tables.py", "fse_kernels.py",
            "huf_kernels.py", "fse_codec.py", "huf_codec.py", "select.py",
            "frame.py", "dp.py", "fse.py", "huf.py", "zlibh.py",
            "blocktypes.py", "bitstream.py", "fseu16.py", "xxhash64.py",
            "u16_codec.py", "fullbench.py", "blockbench.py"} <= {f.name for f in files}
    offenders = [str(f.relative_to(REPO)) for f in files
                 if bad.search(f.read_text())]
    assert offenders == []
