"""``chip_smoke.py`` loaded as a module (no JAX import), for the tests of
its paper suite: ``paper_suite``, ``suite_input``, ``suite_forward`` and
phase 19's launch tables."""

import functools
import importlib.util
from pathlib import Path


@functools.lru_cache(maxsize=None)
def chip_smoke():
    """The module, loaded once a process."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
