"""Error model.

The reference returns negative size_t codes (lib/error_public.h:45-56); the
port raises typed exceptions host-side; its CUDA kernels cannot raise, so
they hand per-group error words back to the host wrappers.
"""
from __future__ import annotations

# error codes (stable ints, used in device-side per-block error arrays)
OK = 0
GENERIC = 1
DST_SIZE_TOO_SMALL = 2
SRC_SIZE_WRONG = 3
CORRUPTION_DETECTED = 4
TABLELOG_TOO_LARGE = 5
MAX_SYMBOL_VALUE_TOO_LARGE = 6
MAX_SYMBOL_VALUE_TOO_SMALL = 7
WORKSPACE_TOO_SMALL = 8

_NAMES = {
    OK: "no error",
    GENERIC: "generic error",
    DST_SIZE_TOO_SMALL: "destination buffer too small",
    SRC_SIZE_WRONG: "source size incorrect",
    CORRUPTION_DETECTED: "corruption detected",
    TABLELOG_TOO_LARGE: "tableLog too large",
    MAX_SYMBOL_VALUE_TOO_LARGE: "maxSymbolValue too large",
    MAX_SYMBOL_VALUE_TOO_SMALL: "maxSymbolValue too small",
    WORKSPACE_TOO_SMALL: "workspace too small",
}


class FSEError(Exception):
    """Raised by host-side codec paths; mirrors the reference error enum."""

    def __init__(self, code: int, detail: str = ""):
        self.code = code
        msg = _NAMES.get(code, f"error {code}")
        super().__init__(f"{msg}{': ' + detail if detail else ''}")


class CorruptionError(FSEError):
    def __init__(self, detail: str = ""):
        super().__init__(CORRUPTION_DETECTED, detail)


def error_name(code: int) -> str:
    return _NAMES.get(code, f"error {code}")
