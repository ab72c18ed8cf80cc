"""Files of the benchmark found by name: ``<kind>/<name>.py`` under this
directory, loaded once as ``portbench.<kind>.<name>`` (dots and dashes of
the name made underscores).

The kinds are ``drivers`` (a path the benchmark drives), ``metrics`` (one
metric's reader), ``archs`` (an architecture: `arch` says what it
provides) and ``reference`` (an architecture's plain reference).  A later
PR adds one of them as a new file; no file here names it.
"""

from __future__ import annotations

import importlib.util
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent


def load(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind.rstrip('s')} {name!r}: {path} is missing")
    mod_name = f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod
