"""Native library loader: builds the C++ runtime pieces with g++ on first
use (cached next to the source), binds them via ctypes.

Reference parity: scannertools_infra's CMake-in-setuptools build that
produces ``lib<module>.so`` per module (scannertools_infra/__init__.py:41-87)
— here a single `g++ -O2 -shared` invocation with a content-hash cache, and
ctypes instead of the engine's dlopen+registration. Callers must degrade
gracefully when no compiler is available (``load() -> None``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_LOCK = threading.Lock()
_CACHE: dict = {}

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           "runtime", "native")

# Extra link/compile flags per native module. st_av binds the system
# libav* (present as distro packages in this image; the build degrades to
# None — and callers to their cv2/WAV fallbacks — when absent).
_EXTRA_FLAGS = {
    "st_av": ["-lavformat", "-lavcodec", "-lswscale", "-lswresample",
              "-lavutil"],
}


def load(name: str = "st_io") -> Optional[ctypes.CDLL]:
    """Build (if needed) and load lib<name>.so; None when unavailable."""
    with _LOCK:
        if name in _CACHE:
            return _CACHE[name]
        src = os.path.join(_NATIVE_DIR, f"{name}.cpp")
        if not os.path.isfile(src):
            _CACHE[name] = None
            return None
        with open(src, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
        build_dir = os.environ.get(
            "SCANNERTOOLS_TPU_BUILD",
            os.path.join(os.path.expanduser("~"), ".scannertools_tpu", "build"),
        )
        os.makedirs(build_dir, exist_ok=True)
        so = os.path.join(build_dir, f"lib{name}-{tag}.so")
        if not os.path.isfile(so):
            # a per-process temp name: concurrent processes may build the
            # same library, and only the atomic rename publishes it
            tmp = f"{so}.{os.getpid()}.tmp"
            try:
                subprocess.run(
                    ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                     "-o", tmp, src]
                    + _EXTRA_FLAGS.get(name, []),
                    check=True, capture_output=True,
                )
                os.replace(tmp, so)
            except (subprocess.CalledProcessError, FileNotFoundError):
                _CACHE[name] = None
                return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            _CACHE[name] = None
            return None
        _configure(name, lib)
        _CACHE[name] = lib
        return lib


def _configure(name: str, lib: ctypes.CDLL) -> None:
    if name == "st_io":
        lib.st_packed_open.restype = ctypes.c_void_p
        lib.st_packed_open.argtypes = [ctypes.c_char_p]
        lib.st_packed_count.restype = ctypes.c_uint64
        lib.st_packed_count.argtypes = [ctypes.c_void_p]
        lib.st_packed_size.restype = ctypes.c_uint64
        lib.st_packed_size.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.st_packed_ptr.restype = ctypes.c_void_p
        lib.st_packed_ptr.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.st_packed_read.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                       ctypes.c_void_p]
        lib.st_packed_close.argtypes = [ctypes.c_void_p]
        lib.st_ring_create.restype = ctypes.c_void_p
        lib.st_ring_create.argtypes = [ctypes.c_size_t, ctypes.c_int]
        lib.st_ring_acquire.restype = ctypes.c_void_p
        lib.st_ring_acquire.argtypes = [ctypes.c_void_p]
        lib.st_ring_commit.argtypes = [ctypes.c_void_p]
        lib.st_ring_front.restype = ctypes.c_void_p
        lib.st_ring_front.argtypes = [ctypes.c_void_p]
        lib.st_ring_release.argtypes = [ctypes.c_void_p]
        lib.st_ring_size.restype = ctypes.c_int
        lib.st_ring_size.argtypes = [ctypes.c_void_p]
        lib.st_ring_destroy.argtypes = [ctypes.c_void_p]
    elif name == "st_av":
        lib.st_av_open.restype = ctypes.c_void_p
        lib.st_av_open.argtypes = [ctypes.c_char_p]
        lib.st_av_open_t.restype = ctypes.c_void_p
        lib.st_av_open_t.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.st_av_meta.restype = ctypes.c_int
        lib.st_av_meta.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64)]
        lib.st_av_error.restype = ctypes.c_char_p
        lib.st_av_error.argtypes = [ctypes.c_void_p]
        lib.st_av_read.restype = ctypes.c_int64
        lib.st_av_read.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_void_p]
        lib.st_av_close.argtypes = [ctypes.c_void_p]
        lib.st_av_audio_decode.restype = ctypes.c_int64
        lib.st_av_audio_decode.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int)]
        lib.st_av_free.argtypes = [ctypes.c_void_p]
        lib.st_av_audio_read_window.restype = ctypes.c_int64
        lib.st_av_audio_read_window.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)]
        lib.st_av_audio_encode.restype = ctypes.c_int
        lib.st_av_audio_encode.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int]
        lib.st_av_read_i420.restype = ctypes.c_int64
        lib.st_av_read_i420.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_void_p]
        lib.st_av_i420_info.restype = ctypes.c_int
        lib.st_av_i420_info.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
