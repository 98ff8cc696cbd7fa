"""Decode staging ring: fixed pre-allocated slots shared between the decode
(prefetch) thread and the device-feed loop.

Reference parity: the engine's io-packet pipeline + block-buffer allocator
(SURVEY §2j work granularity; scanner/util/memory.h) — decoded frames land
in reusable page-aligned native buffers instead of fresh numpy allocations
per chunk (~60 MB/chunk at 480p; allocation + page-fault cost is real on
the host). Backed by runtime/native/st_io.cpp's lock-free SPSC ring; falls
back to plain numpy allocation when no compiler is available.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np

from ..utils import native as native_mod


class ChunkRing:
    """Single-producer single-consumer ring of fixed-size byte slots."""

    def __init__(self, slot_bytes: int, nslots: int):
        self._lib = native_mod.load("st_io")
        self.slot_bytes = slot_bytes
        self.nslots = nslots
        self._r = None
        self._cancelled = False
        if self._lib is not None:
            self._r = self._lib.st_ring_create(slot_bytes, nslots)

    @property
    def native(self) -> bool:
        return self._r is not None

    def cancel(self) -> None:
        """Wake a producer blocked in acquire() (consumer is shutting down).
        Must be called before close() while the decode thread may still be
        running — close() frees the slot memory the producer writes into."""
        self._cancelled = True

    def acquire(self, timeout: float = 900.0) -> np.ndarray:
        # generous timeout: the consumer may stall minutes on a first-chunk
        # XLA compile while the producer waits for a free slot
        """Producer: a writable uint8 view of the next free slot."""
        if self._r is None:
            return np.empty(self.slot_bytes, np.uint8)
        deadline = time.monotonic() + timeout
        while True:
            if self._cancelled or self._r is None:
                raise RuntimeError("ChunkRing cancelled/closed")
            ptr = self._lib.st_ring_acquire(self._r)
            if ptr:
                return np.ctypeslib.as_array(
                    ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
                    shape=(self.slot_bytes,),
                )
            if time.monotonic() > deadline:
                raise TimeoutError("ChunkRing full for too long")
            time.sleep(0.001)

    def commit(self) -> None:
        if self._r is not None:
            self._lib.st_ring_commit(self._r)

    def release(self) -> None:
        """Consumer: recycle the oldest slot. Call only after all device
        transfers reading the slot have completed."""
        if self._r is not None:
            self._lib.st_ring_release(self._r)

    def close(self) -> None:
        if self._r is not None:
            self._lib.st_ring_destroy(self._r)
            self._r = None

    def __del__(self):
        self.close()
