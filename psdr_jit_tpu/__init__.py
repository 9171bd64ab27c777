"""The package's former name, kept so that existing imports still work.

Importing this package, or any ``<former name>.x.y`` below it, gives the very
module objects of :mod:`psdr_jax` (no second copy is loaded).  New code
imports ``psdr_jax``.
"""

import importlib
import importlib.abc
import importlib.util
import sys

import psdr_jax

_OLD = __name__


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Finds ``<former name>.x.y`` as ``psdr_jax.x.y``."""

    def find_spec(self, name, path=None, target=None):
        if not name.startswith(_OLD + "."):
            return None
        return importlib.util.spec_from_loader(name, self)

    def create_module(self, spec):
        module = importlib.import_module("psdr_jax" + spec.name[len(_OLD):])
        spec.loader_state = module.__spec__
        return module

    def exec_module(self, module):
        # the import system set the alias's spec; give the module its own back
        module.__spec__ = module.__spec__.loader_state


if not any(isinstance(f, _Alias) for f in sys.meta_path):
    sys.meta_path.insert(0, _Alias())
sys.modules[_OLD] = psdr_jax
