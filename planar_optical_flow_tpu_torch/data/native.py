"""ctypes bindings of the native data-path library (``native/pofnative.cpp``):
a numeric CSV reader and an LZF decoder.

Counterpart of ``planar_optical_flow_tpu/data/native.py``, with its
semantics: the library is compiled with ``g++`` at first use, and every
entry returns ``None`` when it is unavailable (no compiler, a failed build
or load), so the callers fall back to numpy and to the Python decoder. A
corrupt LZF stream raises ``ValueError`` and does not fall through.

The source is used as it is in the checkout. The library is built into
``build/native/`` beside the package (listed in ``.gitignore``), named
after the hash of the source and of the flags, so a changed source is
rebuilt and an unchanged one is not; a build goes to a temporary name and
is moved into place, so concurrent processes never load half a file.
:func:`status` says which library serves, or why none does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

REPO_DIR = Path(__file__).resolve().parents[2]
SOURCE = REPO_DIR / "native" / "pofnative.cpp"
BUILD_DIR = REPO_DIR / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB = None
_TRIED = False
_STATUS = "not loaded yet"


def library_path() -> Path:
    """Where the source is built: named after the hash of the source and
    of the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"pofnative-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()


def _load():
    global _LIB, _TRIED, _STATUS
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            lib.pof_read_csv.restype = ctypes.c_int
            lib.pof_read_csv.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.pof_free.argtypes = [ctypes.c_void_p]
            lib.pof_lzf_decompress.restype = ctypes.c_int64
            lib.pof_lzf_decompress.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ]
            _LIB, _STATUS = lib, f"native ({out})"
        except Exception as e:  # noqa: BLE001 - any failure: the fallbacks
            _LIB, _STATUS = None, f"unavailable ({type(e).__name__}: {e})"
        return _LIB


def status() -> str:
    """``"native (<library path>)"``, or ``"unavailable (<reason>)"``
    (loading the library first if that was not tried yet)."""
    _load()
    return _STATUS


def read_csv(path: str) -> np.ndarray | None:
    """Parse a numeric CSV into ``(rows, cols)`` float64, or None (the
    library is unavailable, or it refuses the file)."""
    lib = _load()
    if lib is None:
        return None
    data = ctypes.POINTER(ctypes.c_double)()
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    rc = lib.pof_read_csv(os.fsencode(path), ctypes.byref(data),
                          ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        return None
    try:
        n = rows.value * cols.value
        arr = np.ctypeslib.as_array(data, shape=(n,)).copy()
        return arr.reshape(rows.value, cols.value)
    finally:
        lib.pof_free(data)


def lzf_decompress(data: bytes, expected_size: int) -> bytes | None:
    """Decode an LZF stream of at most ``expected_size`` bytes. None only
    when the library is unavailable (the caller falls back to the Python
    decoder); a corrupt stream raises ``ValueError``."""
    lib = _load()
    if lib is None:
        return None
    out = (ctypes.c_uint8 * expected_size)()
    n = lib.pof_lzf_decompress(data, len(data), out, expected_size)
    if n < 0:
        raise ValueError(
            "corrupt LZF stream (out-of-range back-reference, truncated "
            "run, or output overflow)")
    return bytes(bytearray(out)[:n])
