"""Lightweight line coverage built on ``sys.monitoring`` (PEP 669).

Where no ``coverage`` package is installed, this module provides the
minimal subset the test pyramid needs: which executable lines of
``gpud_tpu_torch`` ran during a test session. It mirrors the role of the
reference's ``go test -cover`` CI step (reference: .github/workflows —
coverage gates on pkg/), implemented the CPython-3.12 way: LINE events
are disabled per-location after the first hit, so steady-state overhead
is near zero.

Usage (standalone)::

    python -m gpud_tpu_torch.tools.cov report cov.json         # summary table
    python -m gpud_tpu_torch.tools.cov report cov.json -m gpud_tpu_torch/cli.py

or as a pytest plugin, which collects over ``gpud_tpu_torch/``::

    TPUD_TORCH_COV=out.json pytest -p gpud_tpu_torch.tools.cov tests/test_torch_*.py

``sys.monitoring.COVERAGE_ID`` is held by one tool at a time, and the
reference package's hook (``TPUD_COV``, tests/conftest.py) takes it when
the test session starts: the plugin refuses to start beside it.
"""

from __future__ import annotations

import io
import json
import os
import sys
from dataclasses import dataclass, field

_TOOL_ID = sys.monitoring.COVERAGE_ID
TOOL_NAME = "tpud-torch-cov"
# the reference package's collector registers the id under this name
REFERENCE_TOOL_NAME = "tpud-cov"
ENV_OUT = "TPUD_TORCH_COV"


class LineCollector:
    """Records the first execution of each (file, line) under ``root``."""

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root) + os.sep
        self.hits: dict[str, set[int]] = {}
        self._active = False

    # -- sys.monitoring plumbing ------------------------------------------
    def _on_line(self, code, lineno):  # noqa: ANN001 - monitoring signature
        fname = code.co_filename
        if fname.startswith(self.root) and not fname.endswith(
            os.sep + "cov.py"
        ):
            self.hits.setdefault(fname, set()).add(lineno)
        # one hit per location is all coverage needs; disabling keeps the
        # interpreter at full speed afterwards
        return sys.monitoring.DISABLE

    def start(self) -> None:
        if self._active:
            return
        owner = sys.monitoring.get_tool(_TOOL_ID)
        if owner == TOOL_NAME:
            # another collector in this process already owns the id (e.g. a
            # module imported twice under two names) — defer to it
            return
        if owner == REFERENCE_TOOL_NAME:
            # two collectors cannot share the id, and a run that asked for
            # the port's coverage must not end with a report of nothing
            raise RuntimeError(
                f"{TOOL_NAME}: sys.monitoring.COVERAGE_ID is held by the "
                f"reference package's collector ({REFERENCE_TOOL_NAME!r}, "
                f"TPUD_COV): unset TPUD_COV or {ENV_OUT}"
            )
        if owner is not None:
            # a foreign profiler/debugger owns COVERAGE_ID: degrade to
            # no-coverage rather than crashing the host process
            sys.stderr.write(
                f"{TOOL_NAME}: tool id owned by {owner!r}; coverage disabled\n"
            )
            return
        sys.monitoring.use_tool_id(_TOOL_ID, TOOL_NAME)
        sys.monitoring.register_callback(
            _TOOL_ID, sys.monitoring.events.LINE, self._on_line
        )
        sys.monitoring.set_events(_TOOL_ID, sys.monitoring.events.LINE)
        self._active = True

    def stop(self) -> None:
        if not self._active:
            return
        sys.monitoring.set_events(_TOOL_ID, sys.monitoring.events.NO_EVENTS)
        sys.monitoring.register_callback(
            _TOOL_ID, sys.monitoring.events.LINE, None
        )
        sys.monitoring.free_tool_id(_TOOL_ID)
        self._active = False

    def dump(self, path: str) -> None:
        data = {f: sorted(lines) for f, lines in sorted(self.hits.items())}
        with open(path, "w", encoding="utf-8") as fh:
            json.dump({"root": self.root, "hits": data}, fh)


# -- static side: which lines COULD run -----------------------------------

def executable_lines(path: str) -> set[int]:
    """All line numbers that carry bytecode in ``path`` (incl. nested
    functions/classes), via recursive ``co_lines`` walk."""
    with open(path, "rb") as fh:
        src = fh.read()
    try:
        top = compile(src, path, "exec")
    except SyntaxError:
        return set()
    lines: set[int] = set()
    stack = [top]
    while stack:
        code = stack.pop()
        for _start, _end, lineno in code.co_lines():
            if lineno is not None:
                lines.add(lineno)
        for const in code.co_consts:
            if isinstance(const, type(top)):
                stack.append(const)
    return lines


def _is_noise_line(text: str) -> bool:
    t = text.strip()
    # co_lines marks def/class headers and bare string (docstring) lines as
    # executable; a module whose functions never ran still "covers" them.
    # Keep them — they are executable — but drop obvious non-statements.
    return t == "" or t.startswith("#")


@dataclass
class FileReport:
    path: str
    total: int
    hit: int
    missing: list[int] = field(default_factory=list)

    @property
    def pct(self) -> float:
        return 100.0 * self.hit / self.total if self.total else 100.0


def build_report(cov_json: str) -> list[FileReport]:
    with open(cov_json, encoding="utf-8") as fh:
        data = json.load(fh)
    root = data["root"]
    hits = {f: set(v) for f, v in data["hits"].items()}

    reports: list[FileReport] = []
    for dirpath, _dirs, files in os.walk(root.rstrip(os.sep)):
        if "__pycache__" in dirpath:
            continue
        for name in sorted(files):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            exe = executable_lines(path)
            if not exe:
                continue
            try:
                with open(path, encoding="utf-8") as fh:
                    srclines = fh.readlines()
            except OSError:
                srclines = []
            exe = {
                n
                for n in exe
                if 1 <= n <= len(srclines)
                and not _is_noise_line(srclines[n - 1])
            }
            got = hits.get(path, set()) & exe
            miss = sorted(exe - got)
            reports.append(FileReport(path, len(exe), len(got), miss))
    reports.sort(key=lambda r: (r.pct, -(r.total - r.hit)))
    return reports


def _ranges(nums: list[int]) -> str:
    if not nums:
        return ""
    out, start, prev = [], nums[0], nums[0]
    for n in nums[1:]:
        if n == prev + 1:
            prev = n
            continue
        out.append(f"{start}-{prev}" if prev > start else str(start))
        start = prev = n
    out.append(f"{start}-{prev}" if prev > start else str(start))
    return ",".join(out)


def format_report(
    reports: list[FileReport], *, show_missing_for: str | None = None
) -> str:
    buf = io.StringIO()
    tot = hit = 0
    for r in reports:
        tot += r.total
        hit += r.hit
        rel = os.path.relpath(r.path)
        buf.write(f"{r.pct:6.1f}%  {r.hit:5d}/{r.total:<5d} {rel}\n")
        if show_missing_for and show_missing_for in rel:
            buf.write(f"         missing: {_ranges(r.missing)}\n")
    pct = 100.0 * hit / tot if tot else 100.0
    buf.write(f"{pct:6.1f}%  {hit:5d}/{tot:<5d} TOTAL\n")
    return buf.getvalue()


# -- pytest plugin (``pytest -p gpud_tpu_torch.tools.cov``) ---------------

_PLUGIN: dict = {}


def pytest_configure(config) -> None:  # noqa: ANN001 - pytest hook
    """Start collecting when ``TPUD_TORCH_COV`` names an output file. It
    runs after tests/conftest.py is imported, so a reference collector
    started there is found holding the id, and the run stops with why."""
    out = os.environ.get(ENV_OUT)
    if not out:
        return
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    collector = LineCollector(root)
    collector.start()
    _PLUGIN["collector"], _PLUGIN["out"] = collector, out


def pytest_unconfigure(config) -> None:  # noqa: ANN001 - pytest hook
    collector = _PLUGIN.pop("collector", None)
    if collector is not None:
        collector.stop()
        collector.dump(_PLUGIN.pop("out"))


def main(argv: list[str]) -> int:
    if len(argv) >= 2 and argv[0] == "report":
        show = None
        if "-m" in argv:
            show = argv[argv.index("-m") + 1]
        reports = build_report(argv[1])
        sys.stdout.write(format_report(reports, show_missing_for=show))
        return 0
    sys.stderr.write(__doc__ or "")
    return 2


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
