"""Storage abstractions.

Reference parity: scannerpy's StorageBackend / StoredStream pair that every
scannertools storage module subclasses (reference
scannertools/scannertools/storage/files.py:9-96 etc.). A ``StoredStream`` is
one job's worth of elements (frames/rows); a ``StorageBackend`` constructs the
underlying reader/writer.

In the TPU-native design streams expose plain Python iterators of *bytes*
elements (plus a typed parse via types.py); the executor moves decoded frame
chunks to HBM itself, so storage stays host-side and simple.
"""

from __future__ import annotations

import abc
from typing import Any, Iterator, Optional, Sequence


class StoredStream(abc.ABC):
    """One stream (sequence of elements) in some storage medium."""

    # --- input side ---
    @abc.abstractmethod
    def __len__(self) -> int: ...

    @abc.abstractmethod
    def load_bytes(self, rows: Optional[Sequence[int]] = None) -> Iterator[bytes]:
        """Yield serialized elements, optionally only the given rows."""

    def type_name(self) -> str:
        return "bytes"

    def load(self, ty=None, rows: Optional[Sequence[int]] = None) -> Iterator[Any]:
        """Parsed elements (reference StoredStream.load, storage/files.py:60-74)."""
        from .. import types as _types

        parse = (ty or _types.get_type(self.type_name())).parse
        for b in self.load_bytes(rows):
            yield parse(b)

    # --- output side ---
    def writer(self, type_name: str) -> "StreamWriter":
        raise NotImplementedError(f"{type(self).__name__} is input-only")

    # --- lifecycle ---
    def exists(self) -> bool:
        return True

    def committed(self) -> bool:
        """True iff a previous job fully wrote this stream
        (reference storage/files.py:86-92)."""
        return self.exists()

    def delete(self) -> None:
        pass

    @property
    def is_video(self) -> bool:
        return False


class StreamWriter(abc.ABC):
    """Append-elements-then-commit writer; idempotent sinks come from
    write-to-temp + atomic rename in implementations.

    Writers that additionally support chunk-granular checkpointing (see
    CacheMode.Resume) set ``supports_shards`` and implement the shard
    methods; elements then arrive as per-chunk batches keyed by the chunk's
    starting row."""

    supports_shards = False

    @abc.abstractmethod
    def append(self, element: bytes) -> None: ...

    @abc.abstractmethod
    def commit(self) -> None: ...

    def abort(self) -> None:
        pass

    # --- shard protocol (supports_shards writers only) -----------------
    def existing_shards(self):
        """-> {start_row: n_elements} of durable chunk shards."""
        return {}

    def append_shard(self, start_row: int, elements) -> None:
        raise NotImplementedError

    def commit_from_shards(self, chunk_starts) -> None:
        """Merge the given (ordered) chunk shards into the final stream."""
        raise NotImplementedError


class StorageBackend(abc.ABC):
    """Factory/namespace for streams of one storage kind."""
