"""The benchmark's files find each other by name, and adding a cell,
configuration or metric is adding files."""
import ast
import json
import shutil

import pytest

from h100_bench import harness
from h100_bench.tests.conftest import BENCH, ROOT


def test_every_cell_names_existing_files(bench):
    names = harness.cell_names()
    assert sorted(w["name"] for w in bench["workloads"]) == names
    for w in bench["workloads"]:
        cell = harness.find_cell(w["name"])
        assert {k: cell.spec[k] for k in ("config", "traffic", "chips", "why")} == {
            k: w[k] for k in ("config", "traffic", "chips", "why")}
        c, t = cell.config, cell.traffic
        for path in (BENCH / "systems" / f"{c['system']}.py",
                     BENCH / "reference" / f"{c['reference']}.py",
                     BENCH / "work" / f"{c['work']}.py",
                     BENCH / "traffic" / f"{t['generator']}.py",
                     BENCH / "loops" / f"{t['loop']}.py"):
            assert path.exists(), path
    for c in bench["configs"]:
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(bench, kind):
    cells = set(harness.cell_names())
    for m in bench[kind]:
        mod = harness.load_module(BENCH / "metrics" / f"{m['name']}.py")
        assert callable(mod.read), m["name"]
        assert set(m.get("workloads", cells)) <= cells


def test_each_cell_reports_setup_another_e2e_and_a_layer(bench):
    for cell in harness.cell_names():
        e2e = {m["name"] for m in harness.metrics_for(bench, cell, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_for(bench, cell, True)


def test_a_new_workload_file_is_found_without_edits(tiny_root, tmp_path, bench):
    """A cell with its own traffic mix and a metric of its own, added as
    three files to a copy of the folder, runs and reports the metric."""
    root = tmp_path / "h100_bench"
    shutil.copytree(tiny_root, root)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    spec = {"config": "turbo_speed", "traffic": "p02_tiny", "chips": 1,
            "why": "near-uniform groups go raw"}
    (root / "workloads" / "turbo_speed.p02_tiny.json").write_text(json.dumps(spec))
    (root / "traffic" / "p02_tiny.json").write_text(json.dumps(
        {"generator": "proba_pool", "loop": "roundtrip", "percent": 2,
         "call_bytes": 20000, "pool": 2, "streams": 2, "stream_bytes": 20000}))
    (root / "metrics" / "calls_per_s.py").write_text(
        "def read(rec):\n    return len(rec.calls) / (rec.calls[-1].t1 - rec.calls[0].t0)\n")
    assert "turbo_speed.p02_tiny" in harness.cell_names(root)
    ext = dict(bench, end_to_end=bench["end_to_end"] + [
        {"name": "calls_per_s", "unit": "1/s", "better": "higher", "bound": 0.1,
         "source": "host_clock"}])
    r = harness.run("turbo_speed.p02_tiny", 7, 0.05, False, device="cpu",
                    root=root, bench=ext)
    assert r["correct"], r["checks"]
    assert {"ratio", "calls_per_s", "setup_s"} <= set(r["metrics"])
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} changed"


def _top_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    forbidden = set(harness.FORBIDDEN)
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        found = set(_top_imports(path)) & forbidden
        assert not found, f"{path.relative_to(ROOT)} imports {found}"
    # the port's name begins with the JAX package's; only whole names count
    assert "finitestateentropy_tpu_torch" not in forbidden


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "finitestateentropy_tpu_torch_probe",
                        types.ModuleType("probe"))
    assert "finitestateentropy_tpu_torch_probe" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.probe", types.ModuleType("probe"))
    assert "jaxlib" in harness.forbidden_modules()
