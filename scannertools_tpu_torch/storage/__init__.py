from .base import StorageBackend, StoredStream, StreamWriter
from .named import NamedStream, NamedVideoStream
from .python import PythonStorage, PythonStream

__all__ = [
    "NamedStream", "NamedVideoStream", "PythonStorage", "PythonStream",
    "StorageBackend", "StoredStream", "StreamWriter",
]
