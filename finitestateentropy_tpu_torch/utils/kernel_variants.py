"""Variants of the flat-rank and v0 decode kernels, built side by side and
timed on one card:

    python -m finitestateentropy_tpu_torch.utils.kernel_variants [name ...]

A variant is the committed source of csrc/rans_decode_flat.cu or
csrc/turbo_fse_decode.cu with a few text substitutions: another number of
state chains a thread, another way to exchange the warps' counts, or one
part of the step taken out.  The last kind (``TIMING_ONLY``) computes wrong
results: it only shows what the part costs.  Every variant is built with
nvcc into build/kernel_variants/ (one process per variant, started
together), launched through its C entry on the batches of chip_smoke.py's
paths (ratio mode on 64 x 1 MiB of Proba80, the totals wire on 3 MiB, v1
pair frames on 8 MiB, v0 frames on 16 x 1 MiB), held against the plain
version and timed (CUDA events, mean of 20 launches, the better of two
rounds).  Prints one JSON line: {"gpu", "ms": {"variant/case": ms},
"exact": {"variant/case": bool}}.  Exits 1 without a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from ..turbo import api
from ..turbo import kernels as v0
from ..turbo import rans_kernels as rk
from ..turbo._build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc
from ..turbo.format import parse_group, turbo_fse_compress
from ..turbo.state import to_tensors
from .probagen import generate_proba

FLAT, V0 = "rans_decode_flat", "turbo_fse_decode"
_CHAINS = "constexpr int kChains = {}; "
_FLAT_EXCHANGE = """\
      const int rc = lane < kWarps ? cnt[s & 1][lane] : 0;
      const int below = __reduce_add_sync(kFull, lane < w ? rc : 0);
      const int total = __reduce_add_sync(kFull, rc);
"""
_FLAT_SELECT_SUM = """\
      int below = 0, total = 0;
#pragma unroll
      for (int q = 0; q < kWarps / 4; ++q) {
        const int4 c4 = reinterpret_cast<const int4*>(cnt[s & 1])[q];
        const int rc[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          below += 4 * q + r < w ? rc[r] : 0;
          total += rc[r];
        }
      }
"""
_V0_SELECT_SUM = """\
        int below = 0, total = 0;
#pragma unroll
        for (int k = 0; k < kWarps / 4; ++k) {
          const int4 c4 = reinterpret_cast<const int4*>(cnt[s & 1])[k];
          const int rt[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            below += 4 * k + r < w ? rt[r] : 0;
            total += rt[r];
          }
        }
"""
_V0_WARP_REDUCE = """\
        const int rc = lane < kWarps ? cnt[s & 1][lane] : 0;
        const int below = __reduce_add_sync(kFull, lane < w ? rc : 0);
        const int total = __reduce_add_sync(kFull, rc);
"""
_V0_BALLOTS = """\
        int excl = 0, wtot = 0;
#pragma unroll
        for (int b = 0; b < kSumBits; ++b) {
          const unsigned bb = __ballot_sync(kFull, (sum >> b) & 1);
          excl += __popc(bb & lt_mask) << b;
          wtot += __popc(bb) << b;
        }
"""
_FLAT_BALLOTS = """\
#pragma unroll
      for (int j = 0; j < kChains; ++j) {
        word[j] |= advance<MODE>(tbl, aux, x[j], tlog, mask) << (kParts * p);
        bal[j] = __ballot_sync(kFull, x[j] < kRansL);
"""
_BARRIER = "      __syncthreads();\n      // every warp is past"

# name -> (source, [(old, new), ...]); substitutions apply in order
VARIANTS = {
    "flat": (FLAT, []),
    "flat_chains1": (FLAT, [(_CHAINS.format(2), _CHAINS.format(1))]),
    "flat_chains4": (FLAT, [(_CHAINS.format(2), _CHAINS.format(4))]),
    "flat_chains8": (FLAT, [(_CHAINS.format(2), _CHAINS.format(8))]),
    # the first design's exchange: every thread sums the counts it selects
    "flat_select_sum": (FLAT, [(_FLAT_EXCHANGE, _FLAT_SELECT_SUM)]),
    # every chain's table read before the first ballot (no shared load
    # moves across a warp vote)
    "flat_loads_first": (FLAT, [(_FLAT_BALLOTS, """\
      uint32_t v[kChains];
#pragma unroll
      for (int j = 0; j < kChains; ++j) v[j] = advance<MODE>(tbl, aux, x[j], tlog, mask);
#pragma unroll
      for (int j = 0; j < kChains; ++j) {
        word[j] |= v[j] << (kParts * p);
        bal[j] = __ballot_sync(kFull, x[j] < kRansL);
""")]),
    "flat_int32_cursor": (FLAT, [("long long cursor = csize[g];",
                                  "int cursor = csize[g];")]),
    "flat_no_barrier": (FLAT, [(_BARRIER, "      // every warp is past")]),
    "flat_no_exchange": (FLAT, [
        (_FLAT_EXCHANGE, "      const int below = mine * w, total = mine * kWarps;\n"),
        (_BARRIER, "      // every warp is past")]),
    "flat_no_ring": (FLAT, [("(x[j] << 16) | ring.at(pc)",
                             "(x[j] << 16) | static_cast<uint16_t>(pc)")]),
    "flat_no_table": (FLAT, [(
        "word[j] |= advance<MODE>(tbl, aux, x[j], tlog, mask) << (kParts * p);",
        "{ const uint32_t e = (x[j] & mask) * 2654435761u; "
        "x[j] = ((e >> 8) & 0xFFFu) * (x[j] >> tlog) + (x[j] & mask) - (e >> 20); "
        "word[j] |= (e & 0xFFu) << (kParts * p); }")]),
    "v0": (V0, []),
    "v0_chains2": (V0, [(_CHAINS.format(4), _CHAINS.format(2))]),
    "v0_chains8": (V0, [(_CHAINS.format(4), _CHAINS.format(8))]),
    "v0_warp_reduce": (V0, [(_V0_SELECT_SUM, _V0_WARP_REDUCE)]),
    "v0_shuffle_scan": (V0, [(_V0_BALLOTS, """\
        int incl = sum;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, d);
          if (lane >= d) incl += y;
        }
        const int excl = incl - sum, wtot = __shfl_sync(kFull, incl, 31);
""")]),
    "v0_no_barrier": (V0, [("        __syncthreads();\n        // every warp is past",
                            "        // every warp is past")]),
}
TIMING_ONLY = ("flat_no_barrier", "flat_no_exchange", "flat_no_ring",
               "flat_no_table", "v0_no_barrier")


def variant_source(name: str) -> str:
    """The source of variant `name`: each substitution must match once."""
    src, subs = VARIANTS[name]
    text = (CSRC / f"{src}.cu").read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise ValueError(f"{name}: {old!r} matches {text.count(old)} times")
        text = text.replace(old, new)
    return text


def build(names) -> dict[str, ctypes.CDLL]:
    out_dir = BUILD_DIR.parent / "kernel_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = out_dir / f"{name}.cu"
        cu.write_text(variant_source(name))
        so = out_dir / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def _cases() -> dict:
    """{case: (launch arguments, the plain version's outputs)} on the card."""
    group = 1 << 20
    corpus = generate_proba(80, 64 * group)

    def flat_case(data, mode, **flags):
        groups = api.parse_groups(api.turbo_compress_device(data, group, **flags))
        ((_w, n_pad, tlog, kind), idxs), = api.plan_decode(groups)[1].items()
        cs, tbl, init, hws, tots, t4, _h = api.stage_decode_batch(
            groups, idxs, n_pad, tlog, mode, kind)
        ins = to_tensors("cuda", csize_hw=cs, tables=tbl, init_states=init, streams=hws)
        cur = (None if tots is None else
               rk._decode_prep(ins["csize_hw"], to_tensors("cuda", steptots=tots)["steptots"])[0])
        want = rk._decode_plain(ins["tables"], ins["init_states"], ins["streams"], t4,
                                tlog, mode, cur, None, None if cur is not None else ins["csize_hw"])
        return (ins, cur, t4, tlog, mode), want[:2]

    cases = {"v1_byte_64": flat_case(corpus, "byte", steptots=False),
             "totals_3": flat_case(corpus[:3 * group], "byte", totals_only=True),
             "v1_pair_8": flat_case(corpus[:8 * group], "pair", pair=1, steptots=False)}
    cs, tbl, init, st, t4, wrows = v0.stage_groups(
        [parse_group(turbo_fse_compress(corpus[i * group:(i + 1) * group]))[0]
         for i in range(16)])
    ins = list(to_tensors("cuda", csize_bits=cs, tables=tbl, init_states=init,
                          streams=st).values())
    cases["v0_16"] = ((ins, t4), v0.turbo_fse_decode_plain(*ins, t4, wrows))
    return cases


def _launcher(lib, src: str, args):
    """(launch(), outputs) of one variant on one case's inputs."""
    entry = f"{src}_launch"
    fn = getattr(lib, entry)
    fn.argtypes = rk._SIGS[entry][1]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    if src == V0:
        (cs, tbl, init, st), t4 = args
        G = tbl.shape[0]
        outs = (torch.empty((G, t4 * 8, 128), dtype=torch.int32, device="cuda"),
                torch.empty((G,), dtype=torch.int32, device="cuda"))
        call = (cs.data_ptr(), tbl.data_ptr(), init.data_ptr(), st.data_ptr(),
                st[0].numel(), outs[0].data_ptr(), outs[1].data_ptr(), G, t4, stream)
    else:
        ins, cur, t4, tlog, mode = args
        tbl, strm = ins["tables"], ins["streams"]
        G = tbl.shape[0]
        outs = (torch.empty((G, t4 * 8, 128), dtype=torch.int32, device="cuda"),
                torch.empty((G, 8, 128), dtype=torch.int32, device="cuda"))
        cend = torch.empty((G,), dtype=torch.int32, device="cuda")
        call = (tbl.data_ptr(), tbl[0].numel(), ins["init_states"].data_ptr(),
                strm.data_ptr(), strm[0].numel() * 2, ins["csize_hw"].data_ptr(),
                None if cur is None else cur.data_ptr(), outs[0].data_ptr(),
                outs[1].data_ptr(), cend.data_ptr(), G, t4, tlog,
                rk._MODE_ID[mode], stream)

    def launch():
        rc = fn(*call)
        if rc:
            raise RuntimeError(f"{entry}: CUDA launch failed (cudaError_t {rc})")
    return launch, outs


def _ms(launch, reps: int = 20) -> float:
    launch()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    names = argv or list(VARIANTS)
    libs = build(names)
    cases = _cases()
    ms, exact = {}, {}
    for _round in range(2):
        for name in names:
            src = VARIANTS[name][0]
            for case, (args, want) in cases.items():
                if (case == "v0_16") != (src == V0):
                    continue
                launch, outs = _launcher(libs[name], src, args)
                key = f"{name}/{case}"
                t = _ms(launch)
                ms[key] = min(ms.get(key, t), t)
                exact[key] = all(torch.equal(o, w) for o, w in zip(outs, want))
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"gpu": gpu, "timing_only": list(TIMING_ONLY), "ms": ms,
                      "exact": exact}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
