"""Files storage: one file per element.

Reference parity: FilesStorage/FilesStream (storage/files.py:9-96) backed by
the C++ Files source/sink (files_source.cpp:33-271, files_sink.cpp:32-105),
which build a storehouse backend from (storage_type, bucket, region,
endpoint) and support posix/gcs/s3 uniformly (files_source.cpp:122-165).
Here posix hits the local filesystem; gcs/s3 go through the SDK-free HTTP
clients in object_store.py (AWS SigV4 / GCS JSON API), with the transport
injectable for hermetic tests.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

from .base import StorageBackend, StoredStream, StreamWriter


class FilesStorage(StorageBackend):
    def __init__(self, storage_type: str = "posix",
                 bucket: Optional[str] = None,
                 region: Optional[str] = None,
                 endpoint: Optional[str] = None,
                 opener=None):
        if storage_type not in ("posix", "gcs", "s3"):
            raise ValueError(
                f"storage_type={storage_type!r}: expected posix/gcs/s3"
            )
        self._storage_type = storage_type
        self._bucket = bucket
        self._region = region
        self._endpoint = endpoint
        self._client = None
        if storage_type != "posix":
            from .object_store import make_client

            self._client = make_client(storage_type, bucket, region,
                                       endpoint, opener=opener)

    @property
    def storage_type(self) -> str:
        return self._storage_type

    @property
    def client(self):
        return self._client


class FilesStream(StoredStream):
    """Stream where each element is a file (reference storage/files.py:52-96).
    With a remote FilesStorage, ``paths`` are object keys in the bucket."""

    def __init__(self, paths: Sequence[str],
                 storage: Optional[FilesStorage] = None):
        self._storage = storage or FilesStorage()
        self._paths = list(paths)

    def __len__(self) -> int:
        return len(self._paths)

    def load_bytes(self, rows=None):
        paths = self._paths
        if rows is not None:
            paths = [paths[i] for i in rows]
        client = self._storage.client
        for path in paths:
            if client is not None:
                yield client.get(path)
            else:
                with open(path, "rb") as f:
                    yield f.read()

    def committed(self) -> bool:
        client = self._storage.client
        if client is not None:
            return all(client.exists(p) for p in self._paths)
        return all(os.path.isfile(p) for p in self._paths)

    def exists(self) -> bool:
        client = self._storage.client
        if client is not None:
            return any(client.exists(p) for p in self._paths)
        return any(os.path.isfile(p) for p in self._paths)

    def delete(self) -> None:
        client = self._storage.client
        for p in self._paths:
            if client is not None:
                client.delete(p)
            else:
                try:
                    os.unlink(p)
                except OSError:
                    pass

    def storage(self) -> FilesStorage:
        return self._storage

    def writer(self, type_name: str) -> "FilesStreamWriter":
        return FilesStreamWriter(self)


class FilesStreamWriter(StreamWriter):
    """Writes element i to paths[i] (files_sink.cpp:61-74)."""

    def __init__(self, stream: FilesStream):
        self._stream = stream
        self._i = 0

    def append(self, element: bytes) -> None:
        if self._i >= len(self._stream._paths):
            raise IndexError(
                f"FilesStream sink got more elements than paths "
                f"({len(self._stream._paths)})"
            )
        path = self._stream._paths[self._i]
        client = self._stream._storage.client
        if client is not None:
            client.put(path, element)
        else:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(element)
            os.replace(tmp, path)
        self._i += 1

    def commit(self) -> None:
        pass
