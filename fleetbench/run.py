"""Benchmark of the port's fleet link sweep, ``gpud_tpu_torch.fleet_scan``.

Run from the root of a checkout, on a host with the cards the cell needs:

    python3 fleetbench/run.py --workload su-hour --seed 7 --seconds 10 --trace 0

It writes the cell's host DBs from ``--seed`` under ``$TMPDIR`` (deleted at
exit), sweeps them for ``--seconds``, judges every sweep against the plain
reference in ``fleetbench/reference/``, and prints one JSON line last:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones from spans and the
profiler's trace), ``device``, with ``--trace 1`` ``breakdown``, and
``checks``, each number compared beside its limit. The checks are also the
last lines on standard error. Earlier lines carry what the line does not:
the card's clocks and power limit, kernel launches per sweep, registers and
spills, rows, and the layout's bytes beside the work's.

Exit codes: 0 with a result; 2 without a CUDA device (or fewer than the
cell needs); 3 if JAX or the JAX package got loaded; 1 on any other error.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# the checkout, in place of this script's folder: ``fleetbench.trace`` must
# not shadow the standard library's ``trace``
sys.path[0] = str(CHECKOUT)


def card_info() -> dict:
    query = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"nvidia_smi": repr(e)}
    return {"nvidia_smi": [ln.strip() for ln in out.splitlines() if ln.strip()], "query": query}


def kernel_info() -> dict:
    try:
        from gpud_tpu_torch.ops._build import kernel_resources

        return kernel_resources()
    except (ImportError, AttributeError, RuntimeError, OSError) as e:
        return {"error": repr(e)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from fleetbench import harness

    cell = harness.find_cell(harness.load_json(CHECKOUT / "BENCHMARK.json"), args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"fleetbench: {cell.name} needs {cell.chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import gpud_tpu_torch.fleet_scan  # noqa: F401  (fails here without the port)

    kind = torch.cuda.get_device_name(0)
    # the CUDA context before the first sweep: sweep_rss_mb's baseline holds it
    torch.cuda.synchronize()

    def read_device() -> dict:
        torch.cuda.synchronize()
        return {"platform": "gpu", "kind": kind, "count": cell.chips,
                "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                         for i in range(cell.chips))}

    with tempfile.TemporaryDirectory(prefix="fleetbench-") as workdir:
        out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), T0,
                               workdir, read_device, expect_devices=cell.chips)

    bad = harness.forbidden_modules()
    if bad:
        print(f"fleetbench: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3

    run = out.pop("run")
    checks = out.pop("checks")
    out["metrics"] = harness.read_metrics(cell.per_layer if args.trace else cell.end_to_end, run)
    if args.trace and run.trace is not None:
        out["device"]["busy_s"] = run.trace.busy_s()
        out["device"]["window_s"] = run.trace.window_s()
        out["breakdown"] = run.trace.breakdown()
    print("fleetbench card: " + json.dumps(card_info()), flush=True)
    print("fleetbench kernels: " + json.dumps(kernel_info()), flush=True)
    print("fleetbench run: " + json.dumps({"workload": cell.name, "seed": args.seed,
                                           "trace": args.trace, **run.info}), flush=True)
    for name, c in checks.items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    out["checks"] = checks
    print(json.dumps({k: out[k] for k in ("correct", "attempted", "failed", "metrics", "device",
                                          "breakdown", "checks") if k in out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
