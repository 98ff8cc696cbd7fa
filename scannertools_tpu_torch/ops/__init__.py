"""Op standard library. Importing this package registers the builtin ops
(the analog of the reference's _register_module at import,
scannertools_infra/__init__.py:90-100)."""

from . import histogram  # noqa: F401
from . import imgproc  # noqa: F401
from . import misc  # noqa: F401
from . import optical_flow  # noqa: F401
from . import shot_detection  # noqa: F401
from . import faces  # noqa: F401  (after imgproc: models import it)
from . import detection_decode  # noqa: F401
from . import objects  # noqa: F401  (after faces: weights loader)
from . import nn_generic  # noqa: F401
from . import pose  # noqa: F401  (after faces: weights loader)
from . import clothing  # noqa: F401  (after faces: weights loader)
from . import legacy_extras  # noqa: F401  (after nn_generic: registry)
from . import tracker  # noqa: F401
from . import vis_labels  # noqa: F401
