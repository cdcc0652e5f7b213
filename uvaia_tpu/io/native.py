"""ctypes bridge to the native FASTA reader (native/fasta_io.cpp).

Compiled on first use with g++ (cached next to the source); callers
fall back to the pure-Python reader when compilation or the codec is
unavailable (bz2 is Python-only; xz and gzip too when the library was
built without the liblzma/zlib headers).  Disable with
UVAIA_TPU_NO_NATIVE=1.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from pathlib import Path

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_SRC = _NATIVE_DIR / "fasta_io.cpp"
_SO = _NATIVE_DIR / "libuvaia_io.so"

_lib = None
_lock = threading.Lock()
_failed = False


def _build() -> bool:
    """g++ the library; where the liblzma/zlib headers are missing,
    build it without xz/gzip decode (UVAIA_NO_CODECS) so raw FASTA and
    the delta/store kernels stay native."""
    base = ["g++", "-O3", "-shared", "-fPIC", "-pthread", str(_SRC),
            "-o", str(_SO)]
    for extra in (["-llzma", "-lz"], ["-DUVAIA_NO_CODECS"]):
        try:
            r = subprocess.run(base + extra, capture_output=True, text=True,
                               timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            return False
        if r.returncode == 0:
            if "-DUVAIA_NO_CODECS" in extra:
                print("uvaia-tpu: native IO built without xz/gzip decode "
                      "(liblzma/zlib headers missing); compressed inputs "
                      "use the Python reader", file=sys.stderr)
            return True
    print(f"uvaia-tpu: native IO build failed, using Python reader:\n"
          f"{r.stderr[-500:]}", file=sys.stderr)
    return False


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        if os.environ.get("UVAIA_TPU_NO_NATIVE"):
            _failed = True
            return None
        # a packaged tree may ship the .so without the source; only
        # rebuild when the source is present and newer
        if not _SO.exists() or (_SRC.exists() and
                                _SO.stat().st_mtime < _SRC.stat().st_mtime):
            if not _build():
                _failed = True
                return None
        try:
            lib = ctypes.CDLL(str(_SO))
        except OSError:
            _failed = True
            return None
        lib.ufa_open.restype = ctypes.c_void_p
        lib.ufa_open.argtypes = [ctypes.c_char_p]
        lib.ufa_next.restype = ctypes.c_int
        lib.ufa_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t)]
        lib.ufa_close.restype = None
        lib.ufa_close.argtypes = [ctypes.c_void_p]
        lib.ufa_has_codecs.restype = ctypes.c_int
        lib.ufa_has_codecs.argtypes = []
        _lib = lib
    return _lib


def reads_natively(path) -> bool:
    """Whether the native reader takes this file: raw FASTA always, xz
    and gzip when the library was built with its codecs, bz2 never."""
    from .compress import sniff_codec
    lib = get_lib()
    if lib is None:
        return False
    codec = sniff_codec(path)
    return codec == "raw" or (codec != "bz2" and lib.ufa_has_codecs() == 1)


def read_fasta_native(path):
    """Generator of (name: str, seq: bytes); raises RuntimeError if the
    native reader cannot handle the file."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native reader unavailable")
    handle = lib.ufa_open(str(path).encode())
    if not handle:
        raise RuntimeError(f"native reader cannot open {path}")
    name_p = ctypes.c_char_p()
    name_l = ctypes.c_size_t()
    seq_p = ctypes.c_void_p()
    seq_l = ctypes.c_size_t()
    try:
        while True:
            rc = lib.ufa_next(handle, ctypes.byref(name_p),
                              ctypes.byref(name_l), ctypes.byref(seq_p),
                              ctypes.byref(seq_l))
            if rc == 0:
                return
            if rc < 0:
                raise RuntimeError(f"native reader error in {path}")
            name = ctypes.string_at(name_p, name_l.value).decode(
                "utf-8", errors="replace")
            seq = ctypes.string_at(seq_p, seq_l.value)
            yield name, seq
    finally:
        lib.ufa_close(handle)
