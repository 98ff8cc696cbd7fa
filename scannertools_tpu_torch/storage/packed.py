"""PackedFile storage: all elements in one container file.

Reference parity: the C++ PackedFile source (packed_file_source.cpp:35-219)
— header ``u64 n; u64 sizes[n]`` then payloads; random reads by
(offset, size). The on-disk format (storage/packed_format.py) is
bit-compatible, and doubles as the named-stream element container.
"""

from __future__ import annotations

import os
from typing import Optional

from .base import StorageBackend, StoredStream, StreamWriter
from .packed_format import PackedAppender, PackedReader


class PackedFileStorage(StorageBackend):
    pass


class PackedFileStream(StoredStream):
    def __init__(self, path: str, storage: Optional[PackedFileStorage] = None):
        self._storage = storage or PackedFileStorage()
        self._path = path
        self._reader: Optional[PackedReader] = None

    def _r(self) -> PackedReader:
        if self._reader is None:
            self._reader = PackedReader(self._path)
        return self._reader

    def __len__(self) -> int:
        return len(self._r())

    def load_bytes(self, rows=None):
        yield from self._r().read(rows)

    def exists(self) -> bool:
        return os.path.isfile(self._path)

    def committed(self) -> bool:
        return self.exists()

    def delete(self) -> None:
        try:
            os.unlink(self._path)
        except OSError:
            pass

    def writer(self, type_name: str) -> StreamWriter:
        return PackedAppender(self._path)

    def storage(self) -> PackedFileStorage:
        return self._storage
