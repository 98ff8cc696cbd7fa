"""Op standard library. Importing this package registers the builtin ops
(the analog of the reference's _register_module at import,
scannertools_infra/__init__.py:90-100)."""

from . import histogram  # noqa: F401
from . import shot_detection  # noqa: F401
