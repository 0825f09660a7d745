"""The benchmark's parts found by name: benchmark/<part>/<name>.py under a
checkout's root, loaded from its file.  A mix's `driver` names a module of
drivers/, a configuration's `data.kind` one of inputs/, and a metric one of
metrics/; a later change adds one as a new file, editing none."""

import importlib.util
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_LOADED = {}


def path(part, name, root=ROOT):
    return Path(root) / "benchmark" / part / f"{name}.py"


def module(part, name, root=ROOT):
    """benchmark/<part>/<name>.py as a module, loaded once a file."""
    p = path(part, name, root).resolve()
    if p not in _LOADED:
        if not p.exists():
            raise KeyError(f"no {part} module {name!r}: {p} is missing")
        spec = importlib.util.spec_from_file_location(f"benchmark_{part}_{name}", p)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[p] = mod
    return _LOADED[p]
