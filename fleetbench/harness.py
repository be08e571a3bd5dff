"""One run of one cell: set-up, the measured window, the judgement, metrics.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration file (the entry's ``file``), its traffic mix
``workloads/<traffic>.json``, the mix's generator ``mixes/<generator>.py``,
and each metric's reader ``metrics/<metric>.py``. Adding a configuration,
a mix, a cell or a metric adds files and entries and edits none. A metric
with a ``workloads`` list is the listed cells' alone; a per-layer metric
without one follows its ``moves``: every cell that reports that end-to-end
metric reports it.

The window calls ``gpud_tpu_torch.fleet_scan.fleet_scan`` back to back (a
closed loop: one operator who waits for each sweep) with the function's
default device and thresholds, ``now`` pinned so that every sweep sees the
same data. It closes when the first sweep that ends at or after
``seconds`` has ended.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import resource
import statistics
import sys
import time
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
CHECKOUT = BENCH_DIR.parent

# the generator's clock: every DB's timestamps hang from it, and every sweep
# is asked about the window that ends there
NOW = 1_760_000_000.0
# rows a writer child takes at the least: starting one (an interpreter and
# numpy, ~0.7 s on the H100 machine's host) pays where it takes that long
# off the writing (~4 us a row there)
ROWS_PER_WRITER = 250_000

FORBIDDEN = ("jax", "jaxlib", "flax", "gpud_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    generator: object
    end_to_end: List[dict]
    per_layer: List[dict]


def find_cell(spec: dict, name: str, checkout: Path = CHECKOUT,
              bench_dir: Path = BENCH_DIR) -> Cell:
    by_name = {w["name"]: w for w in spec["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(by_name)})")
    w = by_name[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    traffic = load_json(bench_dir / "workloads" / f"{w['traffic']}.json")
    gen = load_module(bench_dir / "mixes" / f"{traffic['generator']}.py",
                      f"fleetbench_mix_{traffic['generator']}")
    end_to_end = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name=name, chips=w["chips"], config=load_json(checkout / cfg_entry["file"]),
                traffic=traffic, generator=gen, end_to_end=end_to_end, per_layer=per_layer)


def read_metrics(entries: List[dict], run, bench_dir: Path = BENCH_DIR) -> Dict[str, dict]:
    """Each metric's reader, ``metrics/<name>.py``'s ``read(run)``; a
    reader that finds nothing returns None and its metric is left out."""
    out = {}
    for m in entries:
        reader = load_module(bench_dir / "metrics" / f"{m['name']}.py",
                             f"fleetbench_metric_{m['name'].replace('.', '_').replace('-', '_')}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


@dataclass
class Run:
    """What a run measured, as the metric readers see it."""

    fleet: object                       # the generator's Fleet, its hosts left out: rows, links
    setup_s: float
    window_s: float
    window_cpu_s: float                 # CPU seconds of the sweeping thread
    sweeps: int
    rss_peak_bytes: int                 # resident, the window's highest
    rss_base_bytes: int                 # resident before the first sweep
    spans: Dict[str, list] = field(default_factory=dict)   # name → [(t0, t1)]
    trace: Optional[object] = None      # trace.DeviceTrace of the window
    info: Dict[str, object] = field(default_factory=dict)


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN)


def write_fleet(fleet, workdir: str, config: Optional[dict] = None,
                marks: Optional[Dict[str, float]] = None, t0: float = 0.0):
    """Every host's DB under ``workdir``. Returns the paths and what the
    store holds (``rows_stored``, ``db_bytes``). A configuration with
    ``store_retention_seconds`` gets the store's older history beneath the
    generated rows (``fleetbench/retained.py``). Any other gets the
    generated rows alone, each host's DB made whole by
    ``store.write_host_file`` in child interpreters side by side (one a
    ``ROWS_PER_WRITER`` rows, at most one a core); if one fails, no DB is
    left and its error is raised."""
    if config is not None and "store_retention_seconds" in config:
        from fleetbench import retained

        paths, store = retained.write_fleet(fleet, workdir, config, marks, t0)
    else:
        from fleetbench.reference.children import call_all
        from fleetbench.store import write_host_file

        paths = [os.path.join(workdir, f"{h.name}.db") for h in fleet.hosts]
        try:
            call_all(write_host_file, [(path, h.links, h.ts, h.states, h.crc, h.tombstones)
                                       for path, h in zip(paths, fleet.hosts)],
                     -(-fleet.rows_stored // ROWS_PER_WRITER))
        except BaseException:
            for path in paths:
                with contextlib.suppress(FileNotFoundError):
                    os.unlink(path)
            raise
        store = {"rows_stored": fleet.rows_stored}
    store["db_bytes"] = sum(os.path.getsize(p) for p in paths)
    return paths, store


def build_fleet(generator: str, config: dict, traffic: dict, seed: int, workdir: str,
                t0: float):
    """The fleet generated from ``seed`` by the mix's ``generator`` (its
    file) and written by ``write_fleet``; ``set_up`` runs it in a child.
    Returns the fleet without its hosts' rows, the paths, the store and the
    set-up's marks."""
    mix = load_module(Path(generator), f"fleetbench_mix_{traffic['generator']}")
    fleet = mix.generate(config, traffic, seed, NOW)
    marks = {"generated": time.perf_counter() - t0}
    paths, store = write_fleet(fleet, workdir, config, marks, t0)
    return replace(fleet, hosts=[]), paths, store, marks


def set_up(cell: Cell, seed: int, workdir: str, t0: float):
    """``build_fleet`` for the cell in a child interpreter, so that the
    generator's and the writer's heap never reach the sweeping process:
    its resident memory before the first sweep is what a ``fleet-scan``
    process has. Returns what ``build_fleet`` does, the marks (seconds
    since ``t0``, on the clock every process shares) with ``start``."""
    from fleetbench.reference.children import call_all

    start = time.perf_counter() - t0
    (fleet, paths, store, marks), = call_all(
        build_fleet, [(cell.generator.__file__, cell.config, cell.traffic, seed, workdir, t0)])
    return fleet, paths, store, {"start": start, **marks}


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, t0: float,
             workdir: str, read_device: Callable[[], dict], expect_devices: int) -> dict:
    """Set up, measure, judge. Returns the result line's fields (without
    ``device``'s trace keys) and the run's ``Run`` under ``"run"``."""
    from fleetbench import judge, trace as tr
    from fleetbench.peaks import H100_SXM, scan_work_bytes
    from fleetbench.reference import fleet as reference

    fleet, paths, store, marks = set_up(cell, seed, workdir, t0)
    marks["written"] = time.perf_counter() - t0
    window = float(cell.traffic["window_seconds"])

    import torch
    import gpud_tpu_torch.fleet_scan as fs
    import gpud_tpu_torch.ops.packed_scan as ps

    spans = tr.Spans()
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    # twice the L2 of each card the scan runs on, written over before each scan
    l2 = [torch.empty(2 * H100_SXM["l2_bytes"], dtype=torch.uint8, device=d)
          for d in (fs._scan_devices(None) if traced else []) if d.type == "cuda"]
    flush = (lambda: [b.zero_() for b in l2]) if l2 else None
    wrapped = tr.install(fs, spans, sync, flush) if traced else []
    sweep = spans.wrap(fs.fleet_scan, "fleet_scan", False, False, sync) if traced else fs.fleet_scan

    marks["imported"] = time.perf_counter() - t0
    rss_base = tr.tree_rss()
    warm = sweep(paths, window_seconds=window, now=NOW)
    marks["warm"] = time.perf_counter() - t0
    launches0 = getattr(ps.scan_links_packed, "launches", None)
    spans.clear()

    results: List[list] = [[warm, 0]]
    raised, errors, times, gc_full = 0, [], [], []
    with contextlib.ExitStack() as stack:
        if traced:
            from torch.profiler import ProfilerActivity, profile, record_function

            prof = stack.enter_context(
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        rss = stack.enter_context(tr.RssSampler())
        gc_clock = stack.enter_context(tr.GcClock())
        if traced:
            stack.enter_context(record_function(tr.ANNOTATION + "window"))
        ru0 = resource.getrusage(resource.RUSAGE_THREAD)
        t_w0, cpu_w0 = time.perf_counter(), time.thread_time()
        while True:
            t_a = time.perf_counter()
            try:
                res = sweep(paths, window_seconds=window, now=NOW)
            except Exception as e:  # a sweep that raises is counted and judged
                raised += 1
                res = None
                if len(errors) < 3:
                    errors.append(repr(e))
            t_b = time.perf_counter()
            times.append(t_b - t_a)
            gc_full.append(gc_clock.count[2])
            if res is not None:
                if res == results[-1][0]:
                    results[-1][1] += 1
                else:
                    results.append([res, 1])
            if t_b - t_w0 >= seconds:
                break
        cpu_s = time.thread_time() - cpu_w0
        ru1 = resource.getrusage(resource.RUSAGE_THREAD)
    window_s = t_b - t_w0
    device = read_device()
    launches = getattr(ps.scan_links_packed, "launches", None)
    tr.uninstall(fs, wrapped)

    run = Run(fleet=fleet, setup_s=t_w0 - t0, window_s=window_s, window_cpu_s=cpu_s,
              sweeps=len(times), rss_peak_bytes=rss.peak, rss_base_bytes=rss_base,
              spans={k: list(v) for k, v in spans.by_name.items()})
    if traced:
        path = os.path.join(workdir, "trace.json")
        prof.export_chrome_trace(path)
        run.trace = tr.DeviceTrace.from_file(path)
        os.unlink(path)

    # the reference, once the window has closed and the device was read; it
    # reads no row older than the generated ones
    t_ref = time.perf_counter()
    ref = reference.sweep(paths, window, NOW,
                          margin_seconds=cell.config["history_before_window_seconds"])
    ref_s = time.perf_counter() - t_ref
    warm_checks, _ = judge.judge([(warm, 1)], 0, ref, expect_devices)
    checks, failed = judge.judge([(r, n) for r, n in results if n], raised, ref, expect_devices)
    checks["warm_sweep_wrong"] = {"value": int(not judge.passed(warm_checks)), "limit": 0}

    run.info = {
        **store, "rows_window": fleet.rows_window,
        "rows_scanned": fleet.rows_scanned, "links": fleet.links_total,
        "t_max": fleet.t_max, "dbs": len(paths), "faults": fleet.kinds,
        "summary": ref["summary"],
        "layout_bytes": fleet.links_total * fleet.t_max * 6,
        "work_bytes": scan_work_bytes(fleet.rows_scanned, fleet.links_total),
        "launches_per_sweep": (None if launches is None or launches0 is None
                               else (launches - launches0) / len(times)),
        "sweep_s_min": min(times), "sweep_s_median": statistics.median(times),
        "sweep_s_max": max(times), "sweep_cpu_s": cpu_s / len(times), "reference_s": ref_s,
        "errors": errors,
        "wrapped": wrapped, "setup_marks_s": marks,
        "gc_s_by_generation": gc_clock.seconds, "gc_count_by_generation": gc_clock.count,
        "sweep_s_all": times, "rss_base_bytes": rss_base, "rss_peak_bytes": rss.peak,
        "gc_full_passes_by_sweep": [b - a for a, b in zip([0] + gc_full, gc_full)],
        "window_thread_rusage": {k: getattr(ru1, k) - getattr(ru0, k) for k in
                                 ("ru_utime", "ru_stime", "ru_minflt", "ru_majflt", "ru_nvcsw",
                                  "ru_nivcsw")},
    }
    return {
        "correct": judge.passed(checks),
        "attempted": len(times),
        "failed": failed,
        "device": device,
        "checks": checks,
        "run": run,
    }
