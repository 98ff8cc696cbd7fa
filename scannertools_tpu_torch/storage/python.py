"""In-process Python data as an input stream.

Reference parity: PythonStorage/PythonStream (storage/python.py:6-29) backed
by the C++ Python source that unpickles a list and re-pickles per element
(python_source.cpp:34-100). Input-only, like the reference.
"""

from __future__ import annotations

import pickle
from typing import Any, Optional, Sequence

from .base import StorageBackend, StoredStream


class PythonStorage(StorageBackend):
    pass


class PythonStream(StoredStream):
    def __init__(self, data: Sequence[Any], storage: Optional[PythonStorage] = None):
        self._storage = storage or PythonStorage()
        self._data = list(data)

    def __len__(self) -> int:
        return len(self._data)

    def type_name(self) -> str:
        return "object"

    def load_bytes(self, rows=None):
        idxs = range(len(self._data)) if rows is None else rows
        for i in idxs:
            yield pickle.dumps(self._data[i])

    def storage(self) -> PythonStorage:
        return self._storage
