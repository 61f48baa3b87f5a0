"""The compat_huf cell: a traced run on the CPU (the frame layer over the
CLI's host twins) is correct and reports the metric that reads the frame
layer's spans; with the Huff0 device codec's plain versions in place of
the twins, its "huf.*" spans are read too; no run without a device
reports a roofline."""
import json
import shutil

from h100_bench import harness

CELL = "compat_huf.p80_16m"
HOST = "huf.decompress_host_ms_per_mib"
TRANSFER = "huf.decompress_transfer_ms_per_mib"
ROOFLINE = "huf.decompress_roofline_pct"

# compat_fse's System with the device codec's plain versions on the CPU
PLAIN_SYSTEM = '''
from pathlib import Path

from h100_bench import harness

Base = harness.load_module(Path(__file__).with_name("compat_fse.py")).System


class System(Base):
    def __init__(self, config, device):
        from finitestateentropy_tpu_torch.models import get_batch_codec

        super().__init__(config, device)
        self.compressor, self.decompressor = get_batch_codec(
            self.codec, block_size=1 << (10 + self.bid), device="cpu")
'''


def test_traced_run_reports_the_span_metric(tiny_root, bench, tmp_path):
    r = harness.run(CELL, 2**31 + 29, 0.2, True, device="cpu", root=tiny_root,
                    bench=bench, trace_dir=tmp_path)
    assert r["correct"], r["checks"]
    listed = {m["name"] for m in harness.metrics_for(bench, CELL, True)}
    assert listed == {HOST, TRANSFER, ROOFLINE}
    # the host twins open only the frame layer's spans
    assert set(r["metrics"]) == {HOST}
    assert r["metrics"][HOST]["value"] > 0
    labels = {label for label, _s in r["breakdown"]["idle_gaps"]}
    assert {"frame.c_checksum", "frame.d_checksum"} <= labels, labels


def test_the_codecs_spans_are_read(tiny_root, bench, tmp_path):
    root = tmp_path / "h100_bench"
    shutil.copytree(tiny_root, root)
    (root / "systems" / "compat_plain.py").write_text(PLAIN_SYSTEM)
    config = json.loads((root / "configs" / "compat_huf.json").read_text())
    (root / "configs" / "compat_huf.json").write_text(
        json.dumps(dict(config, system="compat_plain")))
    r = harness.run(CELL, 2**31 + 31, 0.2, True, device="cpu", root=root,
                    bench=bench, trace_dir=tmp_path)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {HOST, TRANSFER}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    labels = {label for label, _s in r["breakdown"]["idle_gaps"]}
    assert {"huf.c_encode", "huf.d_decode"} <= labels, labels


def test_untraced_run_reports_the_end_to_end_metrics(tiny_root, bench):
    r = harness.run(CELL, 7, 0.1, False, device="cpu", root=tiny_root, bench=bench)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"decompress_gbps", "ratio", "setup_s"}
    assert r["metrics"]["ratio"]["value"] > 5
