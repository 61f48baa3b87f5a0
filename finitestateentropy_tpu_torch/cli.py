"""Command-line interface: the JAX package's CLI (flag-compatible with the
reference `fse` CLI, programs/commandline.c:94-109) on the GPU.

  python -m finitestateentropy_tpu_torch.cli [-e|-h|-z|--auto] [-d] [-t]
      [-B#] [-f] [-v|-q] [--mesh N] [--device host|cuda] input [output]
  python -m finitestateentropy_tpu_torch.cli -T [-d] [-t] [-f] [-M#] [-G#]
      [--ratio | --sect rows|totals|none] [--pair N] [--quad N]
      [--mesh N] [--windows N] [--device host|cuda] input [output]
  ('-' reads stdin / writes stdout, as in the reference)

The compat codecs (-e FSE, the default; -h Huff0; --auto picks one from
block histograms) write and read the reference's .fse frames through the
device codecs (models/) on CUDA, built at the frame's block size; -d / -t
decode a frame by its magic.  -T runs the TurboRANS entry points on CUDA.
Without a CUDA device both exit 1 unless `--device host` asks for the
CPU: the host twins for the compat codecs (the JAX CLI's default), the
native host codec for -T when it is built (native.py) and otherwise the
entry points on the CPU.  -z (zlib's Huffman coder) has no device codec
in either package: it compresses only with --device host, and zlibh
frames always decode through the twin.

  python -m finitestateentropy_tpu_torch.cli -b [-e|-h|-z] [-T] [-i#] [-B#]
      [--device host|cuda] file [file ...]

Bench mode (-b, benchmarks/blockbench.py) prints a ratio and MB/s line per
file to stderr, after an XXH32 round-trip check: the compat codec on CUDA
at -B's chunk size (32 KiB by default), the TurboRANS entry points with
-T, the host twins with --device host (it exits 1 without CUDA
otherwise); -z runs the reference binary's bench when it is built.
"""
from __future__ import annotations

import argparse
import sys
import time

from .config import FIO_BLOCKSIZEID_DEFAULT

FSE_EXTENSION = ".fse"
TURBO_EXTENSION = ".tfse"
RANS_TABLELOG_DEFAULT = 11  # turbo/rans.py RANS_TABLELOG (import-free: the CLI
#                             loads torch only for the paths that need it)


def _block_size_to_id(bsize: int) -> int:
    bid = 0
    while (1 << (10 + bid)) < bsize and bid < 6:
        bid += 1
    return bid


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fse-torch", add_help=False)
    p.add_argument("-e", dest="codec", action="store_const", const="fse", help="use FSE (default)")
    p.add_argument("-h", dest="codec", action="store_const", const="huf", help="use HUF")
    p.add_argument("-z", dest="codec", action="store_const", const="zlibh", help="use zlib huffman")
    p.add_argument("-d", dest="decode", action="store_true", help="decompression")
    p.add_argument("-t", dest="test", action="store_true", help="test mode (decode, no output)")
    p.add_argument("-b", dest="bench", action="store_true", help="benchmark mode")
    p.add_argument("-i", dest="iters", type=int, default=4, help="benchmark iterations")
    p.add_argument("-B", dest="bsize", type=str, default=None, help="block size (K/M suffix)")
    p.add_argument("-M", dest="table_log", type=int, default=0,
                   help="tableLog (0 = mode default: turbo 10 speed / 11 "
                        "ratio, compat 11)")
    p.add_argument("-f", dest="force", action="store_true", help="overwrite output")
    p.add_argument("-v", dest="verbose", action="count", default=0)
    p.add_argument("-q", dest="quiet", action="count", default=0)
    p.add_argument("-H", "--help", action="help")
    p.add_argument("--auto", action="store_true",
                   help="pick FSE vs HUF per file from block histograms")
    p.add_argument("-T", "--turbo", action="store_true",
                   help="TurboRANS frame format (lane-interleaved)")
    p.add_argument("--ratio", action="store_true",
                   help="turbo ratio mode (omit the speed section; pair "
                        "with -G 4M for best ratio)")
    p.add_argument("--sect", choices=["rows", "totals", "none"],
                   default="rows",
                   help="turbo speed-section wire: rows = fastest decode "
                        "(default), totals = 4x smaller section, slower "
                        "decode, none = best ratio (same as --ratio)")
    p.add_argument("-G", dest="group", type=str, default="1M",
                   help="turbo group size (K/M suffix)")
    p.add_argument("--device", choices=["host", "cuda"], default=None,
                   help="compute path: cuda (the default) or host (the "
                        "host twins; with -T the native codec, else the "
                        "entry points on the CPU)")
    p.add_argument("--mesh", type=int, default=0, help="data-parallel device count")
    p.add_argument("--windows", type=int, default=0,
                   help="turbo decode entry: N > 1 the windowed entry at "
                        "N-way interleave (rows wire), 1 the resident "
                        "entry, 0 = picked per batch")
    p.add_argument("--pair", type=int, default=-1, choices=[-1, 0, 1],
                   help="turbo order-1 pair wire (2 bytes/decode-step): -1 "
                        "auto per group (default), 0 off, 1 force when "
                        "eligible")
    p.add_argument("--quad", type=int, default=-1, choices=[-1, 0, 1],
                   help="turbo order-3 quad wire (4 bytes/decode-step): "
                        "-1 auto per group (default), 0 off, 1 force")
    p.add_argument("--pair-tlog", type=int, default=0,
                   help="pair-wire tableLog (0 = default 9)")
    p.add_argument("--quad-tlog", type=int, default=0,
                   help="quad-wire tableLog (0 = default 10)")
    p.add_argument("input", nargs="?")
    p.add_argument("output", nargs="?")
    p.add_argument("rest", nargs="*",
                   help="additional files (benchmark mode only)")
    return p


def _read_input(path: str) -> bytes:
    """'-' reads stdin, as the reference CLI does (commandline.c:222-257)."""
    if path == "-":
        return sys.stdin.buffer.read()
    with open(path, "rb") as f:
        return f.read()


def _write_output(path: str, data: bytes) -> None:
    if path == "-":
        sys.stdout.buffer.write(data)
        sys.stdout.buffer.flush()
    else:
        with open(path, "wb") as f:
            f.write(data)


def _refuse_overwrite(path: str, force: bool) -> bool:
    """Reference behavior (fileio.c:222-257): without -f, an existing output
    triggers a y/N console prompt when stdin is interactive, otherwise the
    operation is refused."""
    import os

    if path == "-" or force or not os.path.exists(path):
        return False
    if sys.stdin.isatty():
        try:
            ans = input(f"Warning: {path} already exists; overwrite? (y/N) ")
        except EOFError:
            ans = ""
        if ans.strip().lower() in ("y", "yes"):
            return False
        print("operation aborted", file=sys.stderr)
        return True
    print(f"Error: {path} already exists; use -f to overwrite",
          file=sys.stderr)
    return True


def _default_out(args, decode: bool, ext: str) -> str:
    if args.output:
        return args.output
    if args.input == "-":
        return "-"
    return args.input.removesuffix(ext) if decode else args.input + ext


def _parse_bsize(s: str) -> int:
    mult = 1
    if s and s[-1] in "Kk":
        mult, s = 1 << 10, s[:-1]
    elif s and s[-1] in "Mm":
        mult, s = 1 << 20, s[:-1]
    return int(s) * mult


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    verbosity = 2 + args.verbose - args.quiet

    if args.bench:
        return _bench_main(args)
    if args.rest:
        print("too many arguments (multi-file lists are bench-mode only, "
              "as in the reference CLI)", file=sys.stderr)
        return 1
    if not args.input:
        print("missing input file", file=sys.stderr)
        return 1
    if args.turbo:
        return _turbo_main(args, verbosity)
    return _compat_main(args, verbosity)


def _bench_main(args) -> int:
    """Bench mode (JAX cli.py:158-170): benchmarks/blockbench over the file
    list.  --device host times the host twins; CUDA (the default) the
    compat codecs, or with -T the TurboRANS entry points."""
    mode = "host" if args.device == "host" else "turbo" if args.turbo else "cuda"
    if mode != "host":
        import torch

        if not torch.cuda.is_available():
            print("Error: bench mode runs on CUDA and no CUDA device is "
                  "available; pass --device host to bench the host twins",
                  file=sys.stderr)
            return 1
    from .benchmarks.blockbench import bench_files

    # reference parity: -i accepts 1..9 only (commandline.c:228-233);
    # bench mode takes a multi-file list
    iters = min(max(args.iters, 1), 9)
    files = ([args.input] + ([args.output] if args.output else [])
             + list(args.rest))
    return bench_files(files, codec=args.codec or "fse", iters=iters,
                       block_size=_parse_bsize(args.bsize) if args.bsize else 32768,
                       device=mode)


def _compat_main(args, verbosity: int) -> int:
    """The .fse frame path (JAX cli.py:141-248): the device codecs on CUDA,
    the host twins with --device host."""
    decode = args.decode or args.test or (args.input.endswith(FSE_EXTENSION)
                                          and not args.codec)
    host = args.device == "host"
    if not decode and args.codec == "zlibh" and not host:
        print("Error: -z (zlibh) has no device codec; pass --device host to "
              "compress with the host twin", file=sys.stderr)
        return 1
    if not host:
        import torch

        if not torch.cuda.is_available():
            print("Error: the compat codecs run on CUDA and no CUDA device is "
                  "available; pass --device host to run the host twins",
                  file=sys.stderr)
            return 1

    from .errors import FSEError
    from .io import frame as fio

    def device_codec(codec: str, bid: int):
        """(compressor, decompressor) of the device codec at the frame's
        block size; (None, None), the host twin, with --device host."""
        if host:
            return None, None
        from .models import get_batch_codec

        return get_batch_codec(codec, mesh=args.mesh, block_size=1 << (10 + bid))

    codec = args.codec or "fse"
    t0 = time.perf_counter()
    try:
        if decode:
            out = _default_out(args, True, FSE_EXTENSION)
            if not args.test and _refuse_overwrite(out, args.force):
                return 1
            frame = _read_input(args.input)
            # the decode side's codec comes from the frame magic
            # (fileio.c:484-500); zlibh frames decode through the twin
            codec_in = fio.CODEC_BY_MAGIC.get(int.from_bytes(frame[:4], "little"))
            dec = None
            if codec_in in ("fse", "huf") and len(frame) > 4 \
                    and frame[4] <= fio.FIO_MAX_BLOCKSIZE_ID:
                dec = device_codec(codec_in, frame[4])[1]
            data = fio.decompress_bytes(frame, dec)
            if args.test:
                if verbosity >= 2:
                    print(f"OK: decoded {len(data)} bytes", file=sys.stderr)
            else:
                _write_output(out, data)
                if verbosity >= 2:
                    print(f"Decoded {len(data)} bytes", file=sys.stderr)
        else:
            out = _default_out(args, False, FSE_EXTENSION)
            if _refuse_overwrite(out, args.force):
                return 1
            bid = (_block_size_to_id(_parse_bsize(args.bsize)) if args.bsize
                   else FIO_BLOCKSIZEID_DEFAULT)
            data = _read_input(args.input)
            if args.auto and not args.codec:
                from .models import choose_codec

                codec = choose_codec(fio.split_blocks(data, 1 << (10 + bid)))
                if verbosity >= 2:
                    print(f"auto: selected {codec}", file=sys.stderr)
            comp = None if codec == "zlibh" else device_codec(codec, bid)[0]
            frame = fio.compress_bytes(data, codec, bid, comp)
            _write_output(out, frame)
            if verbosity >= 2:
                ratio = 100.0 * len(frame) / len(data) if data else 0.0
                print(f"Compressed {len(data)} bytes into {len(frame)} bytes "
                      f"==> {ratio:.2f}%", file=sys.stderr)
    except (FSEError, OSError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    if verbosity >= 3:
        print(f"elapsed: {time.perf_counter() - t0:.3f}s", file=sys.stderr)
    return 0


def _turbo_main(args, verbosity: int) -> int:
    """TurboRANS frame path: the entry points on CUDA; --device host asks
    for the CPU: the native host codec when it is built, else the entry
    points on the CPU (the JAX CLI's order when no TPU answers)."""
    import torch

    device = "cuda"
    if args.device == "host":
        from . import native

        if native.available():
            encode = not (args.decode or args.test)
            if encode and args.ratio and args.table_log and \
                    args.table_log != RANS_TABLELOG_DEFAULT:
                print(f"warning: ratio-mode native frames are tableLog "
                      f"{RANS_TABLELOG_DEFAULT}; ignoring -M {args.table_log}",
                      file=sys.stderr)
            return _turbo_native_main(args, verbosity)
        device = "cpu"
    elif not torch.cuda.is_available():
        print("Error: -T runs on CUDA and no CUDA device is available; pass "
              "--device host to run on the CPU", file=sys.stderr)
        return 1

    from .turbo.api import turbo_compress_device, turbo_decompress_device

    decode = args.decode or args.test or args.input.endswith(TURBO_EXTENSION)
    data = _read_input(args.input)
    t0 = time.perf_counter()
    if decode:
        dst = _default_out(args, True, TURBO_EXTENSION)
        if not args.test and _refuse_overwrite(dst, args.force):
            return 1
        out = turbo_decompress_device(data, mesh=args.mesh,
                                      windows=args.windows, device=device)
        if not args.test:
            _write_output(dst, out)
        if verbosity >= 2:
            print(f"Decoded {len(out)} bytes in {time.perf_counter()-t0:.2f}s "
                  "(includes the kernels' build on first use)", file=sys.stderr)
    else:
        dst = _default_out(args, False, TURBO_EXTENSION)
        if _refuse_overwrite(dst, args.force):
            return 1
        kw = {"table_log": args.table_log} if args.table_log else {}
        sect = "none" if args.ratio else args.sect
        blob = turbo_compress_device(data, group_size=_parse_bsize(args.group),
                                     steptots=sect != "none",
                                     totals_only=sect == "totals",
                                     mesh=args.mesh, pair=args.pair,
                                     quad=args.quad,
                                     pair_table_log=args.pair_tlog,
                                     quad_table_log=args.quad_tlog,
                                     device=device, **kw)
        _write_output(dst, blob)
        if verbosity >= 2:
            ratio = 100.0 * len(blob) / max(len(data), 1)
            print(f"Compressed {len(data)} bytes into {len(blob)} bytes "
                  f"==> {ratio:.2f}%", file=sys.stderr)
    return 0


def _turbo_native_main(args, verbosity: int) -> int:
    from .native import (rans_compress2_native, rans_compress_native,
                         rans_decompress_native)

    decode = args.decode or args.test or args.input.endswith(TURBO_EXTENSION)
    data = _read_input(args.input)
    t0 = time.perf_counter()
    if decode:
        dst = _default_out(args, True, TURBO_EXTENSION)
        if not args.test and _refuse_overwrite(dst, args.force):
            return 1
        out = rans_decompress_native(data)
        if not args.test:
            _write_output(dst, out)
        if verbosity >= 2:
            print(f"Decoded {len(out)} bytes "
                  f"({len(out)/max(time.perf_counter()-t0,1e-9)/1e6:.0f} MB/s, native)",
                  file=sys.stderr)
    else:
        dst = _default_out(args, False, TURBO_EXTENSION)
        if _refuse_overwrite(dst, args.force):
            return 1
        if args.ratio:   # v1 frames: no section, tableLog 11
            blob = rans_compress_native(data,
                                        group_size=_parse_bsize(args.group))
        else:            # speed frames (FLAG_STEPTOTS/ROWS4), -M honored
            blob = rans_compress2_native(data,
                                         group_size=_parse_bsize(args.group),
                                         table_log=args.table_log or 0)
        _write_output(dst, blob)
        if verbosity >= 2:
            ratio = 100.0 * len(blob) / max(len(data), 1)
            print(f"Compressed {len(data)} bytes into {len(blob)} bytes "
                  f"==> {ratio:.2f}% "
                  f"({len(data)/max(time.perf_counter()-t0,1e-9)/1e6:.0f} MB/s, native)",
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
