from .audio import AudioStorage, AudioStream
from .base import StorageBackend, StoredStream, StreamWriter
from .captions import CaptionStorage, CaptionStream
from .files import FilesStorage, FilesStream
from .named import NamedStream, NamedVideoStream
from .packed import PackedFileStorage, PackedFileStream
from .python import PythonStorage, PythonStream

__all__ = [
    "AudioStorage", "AudioStream", "CaptionStorage", "CaptionStream",
    "FilesStorage", "FilesStream", "NamedStream", "NamedVideoStream",
    "PackedFileStorage", "PackedFileStream", "PythonStorage", "PythonStream",
    "StorageBackend", "StoredStream", "StreamWriter",
]
