"""Run a script written for the JAX package on the port, unedited.

A meta-path finder resolves the name ``scannertools_tpu`` and every
submodule under it to the port's module of the same path
(``scannertools_tpu.ops.vis_labels`` is ``scannertools_tpu_torch.ops.
vis_labels``, one module object under both names), so a script's
``import scannertools_tpu as st`` runs the port. Nothing of the JAX
package is imported: the finder stands first on ``sys.meta_path``, and
after the script ``run`` raises if ``jax`` or any file of the JAX
package's directory was loaded.

    python -m scannertools_tpu_torch.tools.jax_alias examples/X.py ARGS

The alias lives in the process that runs the script: run it as a
subprocess to keep another process's names as they are.
"""

from __future__ import annotations

import importlib
import importlib.abc
import importlib.util
import os
import runpy
import sys
from typing import List, Sequence

ALIAS = "scannertools_tpu"
PORT = "scannertools_tpu_torch"


class AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """``scannertools_tpu[.x.y]`` -> the already imported
    ``scannertools_tpu_torch[.x.y]``."""

    @staticmethod
    def _real(fullname: str):
        return importlib.import_module(PORT + fullname[len(ALIAS):])

    def find_spec(self, fullname, path=None, target=None):
        if fullname != ALIAS and not fullname.startswith(ALIAS + "."):
            return None
        real = self._real(fullname)
        return importlib.util.spec_from_loader(
            fullname, self, is_package=hasattr(real, "__path__"))

    def create_module(self, spec):
        return self._real(spec.name)

    def exec_module(self, module):
        pass  # the port's module ran when it was imported under its name


def install() -> None:
    if not any(isinstance(f, AliasFinder) for f in sys.meta_path):
        sys.meta_path.insert(0, AliasFinder())


def jax_package_modules() -> List[str]:
    """The loaded modules that are JAX or come from the JAX package's
    directory (none, under the alias)."""
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ALIAS) + os.sep
    out = []
    for name, mod in list(sys.modules.items()):
        f = getattr(mod, "__file__", None) or ""
        if name == "jax" or name.startswith("jax.") or name == "flax" \
                or os.path.abspath(f).startswith(root):
            out.append(name)
    return sorted(out)


def run(script: str, argv: Sequence[str]) -> None:
    """``script`` as ``__main__`` with ``argv``, under the alias."""
    install()
    sys.argv = [script, *argv]
    sys.path.insert(0, os.path.dirname(os.path.abspath(script)))
    runpy.run_path(script, run_name="__main__")
    loaded = jax_package_modules()
    if loaded:
        raise RuntimeError(f"the alias loaded JAX modules: {loaded[:5]}")


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    run(sys.argv[1], sys.argv[2:])
