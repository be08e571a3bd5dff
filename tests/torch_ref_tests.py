"""The reference's own tests, run on the port.

``port_tests(name)`` reads ``tests/<name>`` (a test module of the
reference package), points every import of ``gpud_tpu`` at
``gpud_tpu_torch`` (and applies the noun ``replace`` pairs a case needs),
executes it as a module of its own, and returns its test functions, renamed
``test_<stem>__<name>``, with the fixtures they define. A port test module
puts them in its globals, so pytest collects and runs the reference's
cases, assertions and fixtures against the port's modules. ``exclude``
names the cases that need a part of the reference the port has not ported,
each with the reason beside it in the calling module.
"""

from __future__ import annotations

import re
import types
from pathlib import Path
from typing import Dict, Iterable, Tuple

TESTS = Path(__file__).resolve().parent


def _is_fixture(obj) -> bool:
    return (getattr(obj, "_pytestfixturefunction", None) is not None
            or type(obj).__name__ == "FixtureFunctionDefinition")


def port_tests(name: str, replace: Iterable[Tuple[str, str]] = (),
               exclude: Iterable[str] = ()) -> Dict[str, object]:
    path = TESTS / name
    src = re.sub(r"\bgpud_tpu\b(?!_torch)", "gpud_tpu_torch", path.read_text())
    for a, b in replace:
        src = src.replace(a, b)
    stem = path.stem[len("test_"):]
    mod = types.ModuleType(f"port_{path.stem}")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)  # noqa: S102 — the repo's own test
    out: Dict[str, object] = {}
    skip = set(exclude)
    for key, obj in vars(mod).items():
        if key.startswith("test_") and callable(obj) and key not in skip:
            out[f"test_{stem}__{key[len('test_'):]}"] = obj
        elif _is_fixture(obj):
            out[key] = obj
    missing = skip - set(vars(mod))
    if missing:
        raise KeyError(f"{name} has no {sorted(missing)}")
    return out
