"""Packed-element container format.

Bit-compatible with the reference's PackedFile source format
(packed_file_source.cpp:104-119): little-endian ``u64 n`` followed by
``u64 sizes[n]`` followed by the concatenated payloads. Used both by the
PackedFile storage backend and as the on-disk element container for named
streams, so named-stream data files can be read by reference tooling.
"""

from __future__ import annotations

import os
import struct
from typing import Iterable, Iterator, List, Optional, Sequence


def write_packed(path: str, elements: Iterable[bytes]) -> int:
    """Write atomically (temp + rename). Returns element count."""
    tmp = path + ".tmp"
    elements = list(elements)
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(elements)))
        for e in elements:
            f.write(struct.pack("<Q", len(e)))
        for e in elements:
            f.write(e)
    os.replace(tmp, path)
    return len(elements)


class PackedReader:
    """Random-access reader (offsets computed once from the header, matching
    packed_file_source.cpp's sizes→offsets pass).

    Uses the native mmap reader (runtime/native/st_io.cpp) when available —
    elements come zero-copy out of the page cache; falls back to seek+read.
    """

    def __init__(self, path: str):
        self.path = path
        self._native = None
        self._h = None
        from ..utils import native as _native_mod

        lib = _native_mod.load("st_io")
        if lib is not None:
            h = lib.st_packed_open(path.encode())
            if h:
                self._native = lib
                self._h = h
                self.sizes = [
                    lib.st_packed_size(h, i)
                    for i in range(lib.st_packed_count(h))
                ]
                return
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            sizes = struct.unpack(f"<{n}Q", f.read(8 * n)) if n else ()
        self.sizes: List[int] = list(sizes)
        self.offsets: List[int] = []
        off = 8 + 8 * n
        for s in self.sizes:
            self.offsets.append(off)
            off += s

    def __len__(self) -> int:
        return len(self.sizes)

    def read(self, rows: Optional[Sequence[int]] = None) -> Iterator[bytes]:
        idxs = range(len(self.sizes)) if rows is None else rows
        if self._native is not None:
            import ctypes

            for i in idxs:
                ptr = self._native.st_packed_ptr(self._h, i)
                yield ctypes.string_at(ptr, self.sizes[i]) \
                    if self.sizes[i] else b""
            return
        with open(self.path, "rb") as f:
            for i in idxs:
                f.seek(self.offsets[i])
                yield f.read(self.sizes[i])

    def __del__(self):
        if self._native is not None and self._h:
            try:
                self._native.st_packed_close(self._h)
            except Exception:
                pass
            self._h = None


class PackedAppender:
    """Streaming writer that buffers sizes and payload to a temp file, then
    rewrites the header on commit (element count unknown up front).

    Temp paths are unique per writer (host + pid + object id): two hosts
    racing on the same stream (e.g. after an over-eager stale-claim reap)
    each write their own temp file and the atomic rename on commit makes
    last-writer-wins instead of interleaved corruption."""

    def __init__(self, path: str):
        import socket

        self.path = path
        uid = f"{socket.gethostname()}.{os.getpid()}.{id(self):x}"
        self._tmp = f"{path}.tmp.{uid}.body"
        self._tmp_hdr = f"{path}.tmp.{uid}"
        self._f = open(self._tmp, "wb")
        self._sizes: List[int] = []

    def append(self, element: bytes) -> None:
        self._f.write(element)
        self._sizes.append(len(element))

    def commit(self) -> None:
        self._f.close()
        tmp = self._tmp_hdr
        with open(tmp, "wb") as out:
            out.write(struct.pack("<Q", len(self._sizes)))
            for s in self._sizes:
                out.write(struct.pack("<Q", s))
            with open(self._tmp, "rb") as body:
                while True:
                    buf = body.read(1 << 20)
                    if not buf:
                        break
                    out.write(buf)
        os.replace(tmp, self.path)
        os.unlink(self._tmp)

    def abort(self) -> None:
        try:
            self._f.close()
            os.unlink(self._tmp)
        except OSError:
            pass
