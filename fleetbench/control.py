"""Show that the comparison that decides ``correct`` can fail.

For each seed and each variant, one short run of a cell goes through the
harness with the timed path replaced or broken, and prints the numbers the
judge compares:

- ``control``: the plain reference put in the program's place, with one
  guarantee of the configuration broken: the set-healthy tombstones are not
  honoured (every row of the window counts);
- ``zero_scan``: the scan returns its results unchanged from zero, as if the
  kernel had not run;
- ``half_dbs``: the loader is handed half of the host DBs;
- ``altered_class``: one link's class is changed where the classes are
  produced.

A cell runs on one card, so no exchange between cards can be left out.
Run from the checkout's root, on the card:

    python3 fleetbench/control.py --workload su-hour --seeds 11,12,13 --seconds 3
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import sys
import tempfile
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(CHECKOUT)


def _control_sweep(db_paths, window_seconds, now, margin_seconds=None, **_kw):
    """The reference's answer with every tombstone ignored."""
    from fleetbench.reference import fleet as reference

    res = reference.sweep(db_paths, window_seconds, now, tombstones=False,
                          margin_seconds=margin_seconds)
    return dict(res, devices=1, window_seconds=window_seconds)


@contextlib.contextmanager
def variant(name: str, margin_seconds=None):
    """Apply one variant to the program's namespace for the block; the
    control reads rows from ``margin_seconds`` before the window on, as the
    harness's reference does."""
    import torch

    import gpud_tpu_torch.fleet_scan as fs

    saved = {k: getattr(fs, k) for k in ("fleet_scan", "scan_links_packed",
                                         "load_fleet_history", "classify_links")}
    if name == "control":
        fs.fleet_scan = functools.partial(_control_sweep, margin_seconds=margin_seconds)
    elif name == "zero_scan":
        def zero_scan(states, counters, valid):
            out = saved["scan_links_packed"](states, counters, valid)
            return type(out)(*(torch.zeros_like(x) for x in out))
        fs.scan_links_packed = zero_scan
    elif name == "half_dbs":
        def half_loader(db_paths, *args, **kwargs):
            return saved["load_fleet_history"](db_paths[: len(db_paths) // 2], *args, **kwargs)
        fs.load_fleet_history = half_loader
    elif name == "altered_class":
        def altered(scan, *args, **kwargs):
            cls = saved["classify_links"](scan, *args, **kwargs).clone()
            cls[0] = (cls[0] + 1) % 3
            return cls
        fs.classify_links = altered
    elif name != "program":
        raise ValueError(f"unknown variant {name!r}")
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(fs, k, v)


VARIANTS = ("control", "zero_scan", "half_dbs", "altered_class")


def run_variants(cell, seeds, seconds: float, variants=VARIANTS) -> list:
    """One short run of ``cell`` (a ``harness.Cell``) for each seed and
    variant; the numbers the judge compared, by run."""
    from fleetbench import harness

    out = []
    for seed in seeds:
        for name in variants:
            with tempfile.TemporaryDirectory(prefix="fleetbench-") as wd, \
                    variant(name, cell.config["history_before_window_seconds"]):
                res = harness.run_cell(cell, seed, seconds, False, time.perf_counter(), wd,
                                       lambda: {}, expect_devices=cell.chips)
            out.append({"workload": cell.name, "seed": seed, "variant": name,
                        "correct": res["correct"], "attempted": res["attempted"],
                        "failed": res["failed"],
                        "checks": {k: c["value"] for k, c in res["checks"].items()}})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)

    from fleetbench import harness

    cell = harness.find_cell(harness.load_json(CHECKOUT / "BENCHMARK.json"), args.workload)
    rows = run_variants(cell, [int(s) for s in args.seeds.split(",")], args.seconds)
    for r in rows:
        print(json.dumps(r), flush=True)
    return 0 if all(not r["correct"] for r in rows if r["variant"] != "program") else 1


if __name__ == "__main__":
    sys.exit(main())
