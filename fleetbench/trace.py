"""Spans around the program's layers, the device trace, and resident memory.

The traced run replaces a few functions in the ``gpud_tpu_torch.fleet_scan``
module namespace, where ``fleet_scan`` and ``_classify_split`` look them up,
by timing wrappers. Each wrapper records its host interval and opens a
profiler annotation of the same name (``fleetbench.<name>``), so the device
trace can be cut by layer. A function the program no longer has is not
wrapped, and the metrics that read its span stay silent.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

# program functions the traced run wraps, and whether the wrapper
# synchronises the device before and after (the copy and the scan, so that
# their spans hold their device work and nothing else)
WRAPPED = {
    "load_fleet_history": (False, False),
    "_classify_split": (False, False),
    "packed_from_numpy": (False, True),
    "scan_links_packed": (True, True),
}
# wrapped functions whose inputs the traced run first evicts from the cards'
# L2 caches, so that the scan reads them from HBM as its roofline counts
# (``peaks.scan_bound_s``): the copy just before it leaves up to 50 MB there
FLUSHED = ("scan_links_packed",)
ANNOTATION = "fleetbench."
NAME_CHARS = 120  # demangled kernel names run to a thousand characters
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Host intervals by name, in ``time.perf_counter`` seconds."""

    def __init__(self) -> None:
        self.by_name: Dict[str, List[Tuple[float, float]]] = defaultdict(list)

    def clear(self) -> None:
        for spans in self.by_name.values():  # the wrappers hold these lists
            spans.clear()

    def wrap(self, fn, name: str, sync_before: bool, sync_after: bool, sync, flush=None):
        from torch.profiler import record_function

        spans = self.by_name[name]

        def timed(*args, **kwargs):
            if flush is not None:
                flush()
            if sync_before:
                sync()
            with record_function(ANNOTATION + name):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                if sync_after:
                    sync()
                spans.append((t0, time.perf_counter()))
            return out

        timed.__wrapped__ = fn
        return timed


def install(module, spans: Spans, sync, flush=None) -> List[str]:
    """Wrap the functions of ``WRAPPED`` that ``module`` has, those of
    ``FLUSHED`` calling ``flush`` first (before the synchronise, so that its
    device work lies outside their spans); return their names.
    ``uninstall`` puts the originals back."""
    done = []
    for name, (before, after) in WRAPPED.items():
        fn = getattr(module, name, None)
        if callable(fn):
            setattr(module, name, spans.wrap(fn, name, before, after, sync,
                                             flush if name in FLUSHED else None))
            done.append(name)
    return done


def uninstall(module, names: List[str]) -> None:
    for name in names:
        setattr(module, name, getattr(module, name).__wrapped__)


# -- the device trace -----------------------------------------------------

class DeviceTrace:
    """What a profiler's Chrome trace says of one window: device operations
    and the harness's annotations, in microseconds of the trace's clock."""

    def __init__(self, events: List[dict]) -> None:
        self.ops: List[Tuple[str, float, float]] = []
        self.kernels: List[Tuple[str, float, float]] = []
        self.notes: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if e.get("cat") in DEVICE_CATS:
                self.ops.append((e.get("name", "?"), t0, t1))
                if e["cat"] == "kernel":
                    self.kernels.append(self.ops[-1])
            elif e.get("cat") == "user_annotation" and e.get("name", "").startswith(ANNOTATION):
                self.notes[e["name"][len(ANNOTATION):]].append((t0, t1))
        windows = self.notes.get("window", [])
        self.window = windows[0] if windows else None

    @classmethod
    def from_file(cls, path: str) -> "DeviceTrace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    def in_window(self) -> List[Tuple[str, float, float]]:
        if self.window is None:
            return []
        w0, w1 = self.window
        return [(n, max(a, w0), min(b, w1)) for n, a, b in self.ops if b > w0 and a < w1]

    def busy(self) -> List[Tuple[float, float]]:
        """Union of device intervals inside the window, merged and sorted."""
        merged: List[List[float]] = []
        for _n, a, b in sorted(self.in_window(), key=lambda x: x[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e6

    def window_s(self) -> Optional[float]:
        return None if self.window is None else (self.window[1] - self.window[0]) / 1e6

    def kernels_in(self, name: str) -> List[Tuple[str, float, float]]:
        """Kernels that overlap an annotation ``name``: with the device
        synchronised on both sides, the kernels launched inside it."""
        spans = self.notes.get(name, [])
        return [(n, a, b) for n, a, b in self.kernels
                if any(a < s1 and b > s0 for s0, s1 in spans)]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps, each named by the innermost annotation at its midpoint."""
        by_name: Dict[str, float] = defaultdict(float)
        for n, a, b in self.in_window():
            by_name[n[:NAME_CHARS]] += (b - a) / 1e6
        ops = sorted(by_name.items(), key=lambda x: -x[1])[:top]
        gaps = []
        if self.window is not None:
            edge = self.window[0]
            for a, b in self.busy() + [(self.window[1], self.window[1])]:
                if a > edge:
                    gaps.append((self._host_at((edge + a) / 2), (a - edge) / 1e6))
                edge = max(edge, b)
        gaps.sort(key=lambda x: -x[1])
        return {"device_ops": [list(x) for x in ops], "idle_gaps": [list(x) for x in gaps[:top]]}

    def _host_at(self, t: float) -> str:
        best, best_len = "harness", float("inf")
        for name, spans in self.notes.items():
            if name == "window":
                continue
            for a, b in spans:
                if a <= t <= b and b - a < best_len:
                    best, best_len = name, b - a
        return best


# -- resident memory --------------------------------------------------------

PAGE = os.sysconf("SC_PAGE_SIZE")


def _rss(pid: str) -> int:
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * PAGE
    except (FileNotFoundError, ProcessLookupError, IndexError, ValueError):
        return 0


def _children(pid: str) -> List[str]:
    out: List[str] = []
    try:
        tids = os.listdir(f"/proc/{pid}/task")
    except FileNotFoundError:
        return out
    for tid in tids:
        try:
            with open(f"/proc/{pid}/task/{tid}/children") as f:
                out += f.read().split()
        except FileNotFoundError:
            pass
    return out


def tree_rss(pid: str = "self") -> int:
    """Resident bytes of a process and every process below it."""
    total, todo = 0, [str(os.getpid()) if pid == "self" else pid]
    while todo:
        p = todo.pop()
        total += _rss(p)
        todo += _children(p)
    return total


class RssSampler:
    """The highest resident memory of this process and its children while
    running: this process every ``interval`` seconds, the whole tree every
    ``tree_every`` samples, by a thread of its own."""

    def __init__(self, interval: float = 0.02, tree_every: int = 25) -> None:
        self.interval = interval
        self.tree_every = tree_every
        self.peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="fleetbench-rss", daemon=True)

    def _run(self) -> None:
        me, n, children = str(os.getpid()), 0, 0
        while True:
            if n % self.tree_every == 0:
                children = tree_rss() - _rss(me)
            self.peak = max(self.peak, _rss(me) + children)
            n += 1
            if self._stop.wait(self.interval):
                return

    def __enter__(self) -> "RssSampler":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, tree_rss())


class GcClock:
    """Seconds the interpreter's cyclic collector ran, by generation."""

    def __init__(self) -> None:
        self.seconds = [0.0, 0.0, 0.0]
        self.count = [0, 0, 0]
        self._t0 = 0.0

    def _cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            g = info["generation"]
            self.seconds[g] += time.perf_counter() - self._t0
            self.count[g] += 1

    def __enter__(self) -> "GcClock":
        import gc

        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc) -> None:
        import gc

        gc.callbacks.remove(self._cb)


def mean_s(spans: Dict[str, list], name: str) -> Optional[float]:
    """Mean seconds of the spans called ``name``; None when there are none."""
    got = spans.get(name)
    return sum(b - a for a, b in got) / len(got) if got else None
