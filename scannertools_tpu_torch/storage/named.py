"""Named-stream storage — the framework's internal table store.

Reference parity: scannerpy's NamedStream / NamedVideoStream tables in the
Scanner database (tests/test_all.py:150-159), including ``committed()``
job-level caching (old/prelude.py:241-262) and ``sc.ingest_videos``.

Layout: ``<db_path>/<name>/`` with
  manifest.json   {"type": column-type, "n": count, "committed": bool, ...}
  data.pack       packed-element container (bit-compatible with the
                  reference's PackedFile format, packed_file_source.cpp:104-119)
  video.mp4       (video streams) the ingested container, decoded on demand
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Iterator, Optional, Sequence

import numpy as np

from .base import StoredStream, StreamWriter
from .packed_format import PackedAppender, PackedReader, write_packed
from ..io import video as videolib


def _stream_dir(db_path: str, name: str) -> str:
    return os.path.join(db_path, name)


class NamedStream(StoredStream):
    """A typed element stream stored in the framework db."""

    def __init__(self, sc, name: str):
        self._db = sc.config.db_path if hasattr(sc, "config") else sc
        self.name = name

    @property
    def _dir(self) -> str:
        return _stream_dir(self._db, self.name)

    @property
    def _manifest_path(self) -> str:
        return os.path.join(self._dir, "manifest.json")

    def _manifest(self) -> Optional[dict]:
        try:
            with open(self._manifest_path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def exists(self) -> bool:
        return self._manifest() is not None

    def committed(self) -> bool:
        m = self._manifest()
        return bool(m and m.get("committed"))

    def delete(self) -> None:
        shutil.rmtree(self._dir, ignore_errors=True)

    def type_name(self) -> str:
        m = self._manifest()
        return m["type"] if m else "bytes"

    def __len__(self) -> int:
        m = self._manifest()
        if not m:
            return 0
        return int(m["n"])

    def load_bytes(self, rows: Optional[Sequence[int]] = None) -> Iterator[bytes]:
        reader = PackedReader(os.path.join(self._dir, "data.pack"))
        yield from reader.read(rows)

    def writer(self, type_name: str) -> "NamedStreamWriter":
        return NamedStreamWriter(self, type_name)


class NamedStreamWriter(StreamWriter):
    supports_shards = True

    def __init__(self, stream: NamedStream, type_name: str):
        self._stream = stream
        self._type = type_name
        os.makedirs(stream._dir, exist_ok=True)
        # Invalidate any previous commit before rewriting.
        try:
            os.unlink(stream._manifest_path)
        except OSError:
            pass
        self._appender = PackedAppender(os.path.join(stream._dir, "data.pack"))
        self._n = 0

    def append(self, element: bytes) -> None:
        self._appender.append(element)
        self._n += 1

    def commit(self) -> None:
        self._appender.commit()
        # drop ALL shard namespaces: the stream content is now final
        for fn in os.listdir(self._stream._dir):
            if fn.startswith("shards_"):
                shutil.rmtree(os.path.join(self._stream._dir, fn),
                              ignore_errors=True)
        with open(self._stream._manifest_path + ".tmp", "w") as f:
            json.dump({"type": self._type, "n": self._n, "committed": True}, f)
        os.replace(self._stream._manifest_path + ".tmp", self._stream._manifest_path)

    def abort(self) -> None:
        self._appender.abort()

    # --- chunk shards (CacheMode.Resume; SURVEY §5 shard manifests) -----
    # ``shard_key`` namespaces shards by the run signature (sampled rows +
    # graph), so a changed Range/Gather between runs can never resume from
    # a previous run's shards. Set by the executor before shard use.
    shard_key: str = "default"

    @property
    def _shard_dir(self) -> str:
        return os.path.join(self._stream._dir, f"shards_{self.shard_key}")

    def existing_shards(self):
        out = {}
        try:
            for fn in os.listdir(self._shard_dir):
                if fn.startswith("shard_") and fn.endswith(".pack"):
                    start, n = fn[6:-5].split("_")
                    out[int(start)] = int(n)
        except OSError:
            pass
        return out

    def append_shard(self, start_row: int, elements) -> None:
        os.makedirs(self._shard_dir, exist_ok=True)
        elements = list(elements)
        write_packed(
            os.path.join(self._shard_dir,
                         f"shard_{start_row:010d}_{len(elements)}.pack"),
            elements,
        )

    def commit_from_shards(self, chunk_starts) -> None:
        shards = self.existing_shards()
        self._appender.abort()
        self._appender = PackedAppender(
            os.path.join(self._stream._dir, "data.pack"))
        self._n = 0
        for a in chunk_starts:
            n = shards[a]
            reader = PackedReader(os.path.join(
                self._shard_dir, f"shard_{a:010d}_{n}.pack"))
            for el in reader.read():
                self.append(el)
        self.commit()


class NamedVideoStream(NamedStream):
    """A video table: decodable frame stream (reference NamedVideoStream).

    Construct with ``path=`` to ingest (records the container + metadata;
    ``inplace`` semantics — we always reference the original file unless
    ``copy=True``, mirroring reference ingest ``inplace=True`` mode).
    """

    def __init__(self, sc, name: str, path: Optional[str] = None, copy: bool = False):
        super().__init__(sc, name)
        if path is not None:
            self._ingest(path, copy=copy)

    def _ingest(self, path: str, copy: bool = False) -> None:
        meta = videolib.probe(path)
        os.makedirs(self._dir, exist_ok=True)
        stored = path
        if copy:
            stored = os.path.join(self._dir, "video" + os.path.splitext(path)[1])
            shutil.copyfile(path, stored)
        manifest = {
            "type": "frame",
            "video": True,
            "path": os.path.abspath(stored),
            "n": meta.num_frames,
            "fps": meta.fps,
            "width": meta.width,
            "height": meta.height,
            "committed": True,
        }
        with open(self._manifest_path + ".tmp", "w") as f:
            json.dump(manifest, f)
        os.replace(self._manifest_path + ".tmp", self._manifest_path)

    @property
    def is_video(self) -> bool:
        return True

    def video_path(self) -> str:
        m = self._manifest()
        if not m or not m.get("video"):
            raise ValueError(f"{self.name} is not an ingested video stream")
        return m["path"]

    def metadata(self) -> videolib.VideoMetadata:
        m = self._manifest()
        return videolib.VideoMetadata(
            path=m["path"], num_frames=int(m["n"]), fps=float(m["fps"]),
            width=int(m["width"]), height=int(m["height"]),
        )

    def decoder(self) -> videolib.VideoDecoder:
        return videolib.VideoDecoder(self.video_path())

    def load_bytes(self, rows: Optional[Sequence[int]] = None) -> Iterator[bytes]:
        from .. import types as _types

        ser = _types.get_type("frame").serialize
        for f in self.load_frames(rows):
            yield ser(f)

    def load_frames(self, rows: Optional[Sequence[int]] = None) -> Iterator[np.ndarray]:
        dec = self.decoder()
        try:
            idxs = list(rows) if rows is not None else list(range(len(self)))
            # Decode in ascending order but yield in requested order.
            order = np.argsort(idxs, kind="stable")
            frames = dec.read_frames([idxs[i] for i in order])
            out = np.empty_like(frames)
            out[order] = frames
            yield from out
        finally:
            dec.close()
