#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gpud_tpu_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device  - the card's name, and its name and power limit from nvidia-smi;
2. build   - compiles gpud_tpu_torch/csrc/*.cu into build/kernels/ and
             prints what ptxas reports of each kernel (registers, spills);
3. kernel  - the packed-scan kernel against its plain PyTorch version on the
             card, exactly equal, one launch per case, on edge cases (T
             around the kernel's 16-sample chunks and 512-sample steps,
             misaligned rows and base pointers, extreme counters) and at the
             fleet-day and retention shapes (4608 x 1440 and 4608 x 20160);
4. fleet   - the main path: 32 host DBs of a 256-GPU pod of 8-GPU HGX H100
             hosts (18 NVLink links per GPU, 144 links per host, L = 4608),
             one day of one-minute snapshots each (T = 1440, 6.6 M rows) with
             seeded faults, scanned by ``fleet_scan`` on the default device;
             it must launch the kernel exactly once, classify every seeded
             fault, agree with ``device="cpu"``, and the CLI must agree too;
5. adapter - the device adapter and the GPU components on the card: NVML
             (``gpu/nvml.py`` through ``NVMLBackend``) against nvidia-smi
             (name, UUID, PCI bus id, memory total, driver, enforced power
             limit, volatile ECC, remapped rows exactly; temperature within
             3 C; the NVLink links and which are active), the binding's
             struct layouts and constants against the toolkit's nvml.h,
             ``TorchBackend`` against NVML, ``scan()`` on the real card,
             then six samples of the card's links (``gpu0/nvlink0`` injected
             down in samples 3-4) through ``NVLinkStore`` into
             ``fleet_scan``, which must launch the kernel once and agree
             with ``NVLinkStore.scan`` and with ``device="cpu"``; printed as
             the ``{"adapter": ...}`` line;
6. analytics - the analytics plane on the card (torch ops, no hand kernel):
             ``robust_scores`` over a fleet of 16384 chips x 180 samples x 8
             features with 16 seeded drifting chips (they must score top
             16, and equal the numpy twin), ``entry()`` and the autoencoder
             at batch 64 and 16384 against ``device="cpu"``, 60 training
             steps (the loss must fall), one step against the CPU's,
             ``dryrun_multichip(1)`` over NCCL; then device ms, host ms,
             kernels per call and the top kernels of four calls beside
             their bounds, printed as the ``{"analytics": ...}`` line;
7. timing  - device time per call of the kernel and of its plain version
             at both shapes, beside the memory bound: CUDA events around
             batches of back-to-back calls on input copies that together
             exceed the L2, with a device spin that keeps the host's
             wrapper time out of the window; beside it the kernel's time
             from torch.profiler, one launch alone after an L2 flush, and
             the wrapper's host time per call.

The ``{"adapter": ...}`` and ``{"analytics": ...}`` lines come before the ``{"kernels": [...]}``
record, which is the line before the last; the last line
is ``{"ok": true, "device": {...}}``. Any failure raises, so the script
exits non-zero without the ``ok`` line. Data comes from fixed seeds.
"""

from __future__ import annotations

import ctypes
import io
import itertools
import json
import os
import re
import shutil
import sqlite3
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from gpud_tpu_torch import fleet_scan as fleet_scan_mod  # noqa: E402
from gpud_tpu_torch.api.v1.types import HealthStateType  # noqa: E402
from gpud_tpu_torch.components.base import FailureInjector  # noqa: E402
from gpud_tpu_torch.components.gpu.nvlink_store import NVLinkStore  # noqa: E402
from gpud_tpu_torch.fleet_scan import (  # noqa: E402
    MAX_STEPS,
    TABLE,
    TOMBSTONE_TABLE,
    fleet_scan,
    load_fleet_history,
)
from gpud_tpu_torch.entry import dryrun_multichip, entry  # noqa: E402
from gpud_tpu_torch.gpu import instance as gpu_instance  # noqa: E402
from gpud_tpu_torch.gpu import nvml as nvml_mod  # noqa: E402
from gpud_tpu_torch.models.anomaly import (  # noqa: E402
    AEConfig,
    AEParams,
    ae_init,
    ae_scores,
    ae_train_step,
    robust_scores,
    windows_to_batch,
)
from gpud_tpu_torch.models.anomaly_np import robust_scores_np  # noqa: E402
from gpud_tpu_torch.ops import _build  # noqa: E402
from gpud_tpu_torch.ops.packed_scan import (  # noqa: E402
    packed_from_numpy,
    scan_links_packed,
    scan_links_packed_reference,
)
from gpud_tpu_torch.ops.window_scan import classify_links  # noqa: E402
from gpud_tpu_torch.scan import scan as host_scan  # noqa: E402
from gpud_tpu_torch.sqlite import DB  # noqa: E402

SEED = 20260
# one 256-GPU pod of 8-GPU HGX H100 hosts, 18 NVLink links per GPU
HOSTS, GPUS_PER_HOST, LINKS_PER_GPU = 32, 8, 18
LINKS_PER_HOST = GPUS_PER_HOST * LINKS_PER_GPU
T_DAY = 1440  # one day of one-minute snapshots
STEP_SECONDS = 60.0
WINDOW_SECONDS = 86400.0

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, and the
# non-tensor 32-bit rate, which bounds the scan's integer compares and adds
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# per sample: 6 bytes read (int8 state, int32 counter, bool valid); about 12
# integer operations (valid test and count, 4 compares, 2 ands, 2 adds, a
# 64-bit subtract, max and add); per link: 5 int64 results written
BYTES_PER_SAMPLE, OPS_PER_SAMPLE, BYTES_PER_LINK_OUT = 6, 12, 5 * 8
L2_BYTES = 50 * 2**20

DDL = (
    f"""CREATE TABLE IF NOT EXISTS {TABLE} (
        ts REAL NOT NULL,
        link TEXT NOT NULL,
        state INTEGER NOT NULL,
        tx_bytes INTEGER NOT NULL DEFAULT 0,
        rx_bytes INTEGER NOT NULL DEFAULT 0,
        tx_errors INTEGER NOT NULL DEFAULT 0,
        rx_errors INTEGER NOT NULL DEFAULT 0,
        crc_errors INTEGER NOT NULL DEFAULT 0,
        replays INTEGER NOT NULL DEFAULT 0
    )""",
    f"CREATE INDEX IF NOT EXISTS idx_{TABLE}_link_ts ON {TABLE} (link, ts)",
    f"CREATE INDEX IF NOT EXISTS idx_{TABLE}_ts ON {TABLE} (ts)",
    f"CREATE TABLE IF NOT EXISTS {TOMBSTONE_TABLE} "
    "(link TEXT PRIMARY KEY, ts REAL NOT NULL)",
)


def line(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# -- 1. device ----------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    name = torch.cuda.get_device_name(0)
    line("device", f"{name}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
                   f"{torch.cuda.device_count()} device(s)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return smi


# -- 2. build -----------------------------------------------------------------

def phase_build() -> dict:
    t0 = time.perf_counter()
    _build.load_library()
    line("build", f"{time.perf_counter() - t0:.3f} s -> "
                  f"{_build.library_path().relative_to(ROOT)}")
    resources = _build.kernel_resources()
    for name, r in resources.items():
        line("build", f"ptxas {name}: " + json.dumps(r))
    if "packed_scan_kernel" not in resources:
        raise AssertionError(f"ptxas reported no packed_scan_kernel: {sorted(resources)}")
    return resources


# -- 3. kernel vs plain version ------------------------------------------------

def packed_case(rng, L, T, *, prefix=True, odd_states=False, empty_rows=0.05):
    """Seeded [L, T] histories: prefix-valid rows of random length (some
    all-invalid, some full), counters with resets, garbage in the padding."""
    states = rng.integers(0, 2, (L, T), dtype=np.int8)
    if odd_states:  # pin the >= 1 / <= 0 rule on values outside {0, 1}
        u = rng.random((L, T))
        states[u < 0.05] = 2
        states[(u >= 0.05) & (u < 0.10)] = -1
    counters = np.cumsum(rng.integers(0, 5, (L, T), dtype=np.int32), axis=1,
                         dtype=np.int32)
    reset_rows = np.flatnonzero(rng.random(L) < 0.3)
    if T > 1 and reset_rows.size:
        k = rng.integers(1, T, reset_rows.size)
        cols = np.arange(T)[None, :]
        sub = counters[reset_rows, k][:, None] * (cols >= k[:, None])
        counters[reset_rows] -= sub.astype(np.int32)
    if prefix:
        n = rng.integers(0, T + 1, L)
        n[rng.random(L) < 0.2] = T
        n[rng.random(L) < empty_rows] = 0
        valid = np.arange(T)[None, :] < n[:, None]
    else:
        valid = rng.random((L, T)) < 0.7
    return states, counters, valid


def boundary_case(rng, T):
    """One row for each valid-prefix length around the kernel's 16-sample
    chunks and 512-sample warp steps: the last valid sample at a lane's
    last slot, a step's last slot, and one past either."""
    ns = [n for n in (0, 1, 15, 16, 17, 31, 32, 33, 511, 512, 513, 527, 528,
                      1023, 1024, 1025, T - 1, T) if n <= T]
    states, counters, _ = packed_case(rng, len(ns), T, odd_states=True)
    return states, counters, np.arange(T)[None, :] < np.array(ns)[:, None]


def extreme_counters_case(rng, L, T):
    """Counters that step between INT32_MIN and INT32_MAX: each positive step
    is 2^32 - 1, and a row's sum passes 2^32 many times over."""
    states, _, valid = packed_case(rng, L, T, empty_rows=0.0)
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    counters = np.tile(np.where(np.arange(T) % 2 == 0, lo, hi).astype(np.int32), (L, 1))
    odd = np.arange(L) % 2 == 1  # these rows: random extremes
    counters[odd] = rng.choice(np.array([lo, hi, -1, 0, 1], dtype=np.int32),
                               (int(odd.sum()), T))
    return states, counters, valid


def offset_view(x: torch.Tensor) -> torch.Tensor:
    """x's values as a contiguous view one element into a larger allocation:
    its data pointer is not 16-byte aligned."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    flat[1:] = x.reshape(-1)
    return flat[1:].view(x.shape)


def compare_on_card(label, states, counters, valid, offset=()) -> int:
    """The kernel against its plain version on one case; the arrays named in
    ``offset`` are passed as views whose data pointers are not aligned."""
    tensors = packed_from_numpy(states, counters, valid, "cuda")
    st, ct, vl = (offset_view(x) if name in offset else x
                  for name, x in zip(("states", "counters", "valid"), tensors))
    before = scan_links_packed.launches
    got = scan_links_packed(st, ct, vl)
    torch.cuda.synchronize()
    if scan_links_packed.launches != before + 1:
        raise AssertionError(f"{label}: {scan_links_packed.launches - before} launches, not 1")
    ref = scan_links_packed_reference(st, ct, vl)
    torch.cuda.synchronize()
    err = 0
    for field in got._fields:
        a, b = getattr(got, field), getattr(ref, field)
        if a.shape != b.shape:
            raise AssertionError(f"{label}: {field} shape {a.shape} != {b.shape}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    if err:
        raise AssertionError(f"{label}: kernel differs from plain version by {err}")
    line("kernel", f"{label:40s} L={states.shape[0]:5d} T={states.shape[1]:6d} "
                   f"exact (max |err| 0), 1 launch")
    return err


def phase_kernel() -> int:
    rng = np.random.default_rng(SEED)
    cases = [
        ("odd L and T", packed_case(rng, 997, 1003), ()),
        ("T = 1", packed_case(rng, 77, 1), ()),
        ("L = 3, T = 17", packed_case(rng, 3, 17), ()),
        ("states 2 and -1", packed_case(rng, 513, 259, odd_states=True), ()),
        ("all rows all-invalid", packed_case(rng, 41, 300, empty_rows=1.0), ()),
        ("ragged (non-prefix) mask", packed_case(rng, 301, 777, prefix=False), ()),
        ("fleet day 4608 x 1440", packed_case(rng, 4608, T_DAY), ()),
        ("retention 4608 x 20160", packed_case(rng, 4608, MAX_STEPS), ()),
    ]
    # T around a 16-sample chunk, a 512-sample warp step and two steps; odd
    # T starts rows off the 16-byte grid
    for T in (15, 16, 17, 511, 512, 513, 1025):
        for L in (3, 997):
            cases.append((f"T = {T}, L = {L}", packed_case(rng, L, T, odd_states=True), ()))
    cases += [
        ("last valid at lane/step edges, T 1040", boundary_case(rng, 1040), ()),
        ("last valid at lane/step edges, T 1041", boundary_case(rng, 1041), ()),
        ("base pointers off 16 B (all three)", packed_case(rng, 997, 1003),
         ("states", "counters", "valid")),
        ("counters' base pointer off 16 B", packed_case(rng, 301, T_DAY), ("counters",)),
        ("valid's base pointer off, ragged mask",
         packed_case(rng, 130, 1040, prefix=False), ("valid",)),
        ("counters INT32_MIN <-> INT32_MAX", extreme_counters_case(rng, 61, 1040), ()),
        ("L = 4609, one row past a block", packed_case(rng, 4609, 64), ()),
    ]
    # the cases must hold counter resets (steps < 0), which add nothing
    _s, c, _v = cases[0][1]
    if not (np.diff(c.astype(np.int64), axis=1) < 0).any():
        raise AssertionError("the odd-shape case holds no counter reset")
    return max(compare_on_card(label, *case, offset=off) for label, case, off in cases)


# -- 4. fleet scan, the main path ------------------------------------------------

def link_name(g: int, k: int) -> str:
    return f"gpu{g}/nvlink{k}"


def seeded_faults(T: int):
    """host index -> {link: (kind, expected class)}; every link not named
    here is healthy."""
    return {
        3: {link_name(2, 5): ("down last hour", "unhealthy")},
        17: {link_name(7, 0): ("down last hour", "unhealthy")},
        30: {link_name(0, 17): ("down last hour", "unhealthy")},
        5: {link_name(1, 3): ("flapping, last 6 h", "unhealthy")},
        21: {link_name(4, 9): ("one drop and recovery", "degraded")},
        8: {link_name(6, 11): ("CRC +150 over 2 h", "degraded")},
        26: {link_name(3, 2): ("CRC +5000 burst", "degraded")},
        14: {link_name(5, 1): ("CRC counter reset, +70", "healthy")},
        # faults before the host's global tombstone at mid-day are forgiven
        12: {
            link_name(0, 0): ("down before tombstone", "healthy"),
            link_name(3, 7): ("flapping before tombstone", "healthy"),
        },
    }


def host_rows(h: int, now: float, T: int):
    links = [link_name(g, k) for g in range(GPUS_PER_HOST)
             for k in range(LINKS_PER_GPU)]
    states = np.ones((len(links), T), dtype=np.int64)
    crc = np.full((len(links), T), 1_000_000_000 + 1000 * h, dtype=np.int64)
    crc += np.arange(len(links))[:, None]
    m = np.arange(T)
    for link, (kind, _cls) in seeded_faults(T).get(h, {}).items():
        i = links.index(link)
        if kind == "down last hour":
            states[i, T - 60:] = 0
        elif kind == "flapping, last 6 h":
            states[i, (m >= T - 360) & (m % 20 < 5)] = 0
        elif kind == "one drop and recovery":
            states[i, T - 180:T - 170] = 0
        elif kind == "CRC +150 over 2 h":
            crc[i] += np.clip(m - (T - 120), 0, None) * 150 // 119
        elif kind == "CRC +5000 burst":
            crc[i, T - 30:] += 5000
        elif kind == "CRC counter reset, +70":
            crc[i] += np.minimum(m, 40)
            crc[i, T // 2:] = np.minimum(m[T // 2:] - T // 2, 30)
        elif kind == "down before tombstone":
            states[i, T // 14:T * 5 // 12] = 0
        elif kind == "flapping before tombstone":
            states[i, (m >= T // 7) & (m < T // 4) & (m % 8 < 3)] = 0
    # the newest sample is 30 s old, one per minute before it
    ts = now - 30.0 - STEP_SECONDS * (T - 1 - m)
    for i, link in enumerate(links):
        yield from zip(ts.tolist(), [link] * T, states[i].tolist(), crc[i].tolist())


def write_host_db(path: Path, h: int, now: float, T: int) -> None:
    conn = sqlite3.connect(path)
    try:
        conn.execute(DDL[0])
        conn.execute(DDL[3])
        conn.executemany(
            f"INSERT INTO {TABLE} (ts, link, state, crc_errors) VALUES (?,?,?,?)",
            host_rows(h, now, T),
        )
        conn.execute(DDL[1])  # indexes after the bulk insert: same schema
        conn.execute(DDL[2])
        if h == 12:
            # set-healthy on the whole host at the middle of its history
            conn.execute(f"INSERT INTO {TOMBSTONE_TABLE} (link, ts) VALUES (?, ?)",
                         ("*", now - STEP_SECONDS * T / 2))
        conn.commit()
    finally:
        conn.close()


def expected_classes(hosts: int, T: int) -> dict:
    exp = {}
    for h in range(hosts):
        for g in range(GPUS_PER_HOST):
            for k in range(LINKS_PER_GPU):
                exp[f"host{h:02d}/{link_name(g, k)}"] = "healthy"
        for link, (_kind, cls) in seeded_faults(T).get(h, {}).items():
            exp[f"host{h:02d}/{link}"] = cls
    return exp


def sync_time(fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_fleet(workdir: Path, hosts: int = HOSTS, T: int = T_DAY) -> dict:
    now = float(int(time.time()))
    t0 = time.perf_counter()
    dbs = []
    for h in range(hosts):
        path = workdir / f"host{h:02d}.db"
        write_host_db(path, h, now, T)
        dbs.append(str(path))
    t_write = time.perf_counter() - t0
    line("fleet", f"wrote {hosts} host DBs, {hosts * LINKS_PER_HOST * T} rows, "
                  f"in {t_write:.2f} s")

    # the main path, through the entry point, on the default device
    scan_links_packed.launches = 0
    res, t_main = sync_time(
        lambda: fleet_scan(dbs, window_seconds=WINDOW_SECONDS, now=now))
    launches = scan_links_packed.launches
    line("fleet", f"fleet_scan: {len(res['links'])} links, {res['summary']}, "
                  f"{t_main:.3f} s, packed_scan launches {launches}")
    if launches != 1:
        raise AssertionError(f"fleet_scan launched the kernel {launches} times, not 1")

    exp = expected_classes(hosts, T)
    if res["links"] != exp:
        bad = {k: (res["links"].get(k), v) for k, v in exp.items()
               if res["links"].get(k) != v}
        raise AssertionError(f"misclassified links (got, expected): {dict(list(bad.items())[:10])}")
    if res["truncated_links"] or res["devices"] != 1:
        raise AssertionError(f"unexpected truncation/devices: {res['truncated_links']}, {res['devices']}")
    line("fleet", "every seeded fault has its expected class, all other links healthy")

    res_cpu = fleet_scan(dbs, window_seconds=WINDOW_SECONDS, now=now, device="cpu")
    for key in ("links", "summary", "truncated_links"):
        if res_cpu[key] != res[key]:
            raise AssertionError(f"device='cpu' disagrees with the card on {key}")
    line("fleet", "device='cpu' gives the same links, summary and truncated_links")

    # the CLI on two of the DBs (it scans up to its own clock)
    pick = [dbs[3], dbs[8]]
    proc = subprocess.run(
        [sys.executable, "-m", "gpud_tpu_torch", "fleet-scan", "--json",
         "--window", str(int(WINDOW_SECONDS)), *pick],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    if proc.returncode not in (0, 1):
        raise AssertionError(f"CLI failed with rc {proc.returncode}: {proc.stderr[-4000:]}")
    cli = json.loads(proc.stdout)
    want = {k: v for k, v in res["links"].items() if k.startswith(("host03/", "host08/"))}
    if cli["links"] != want or cli["devices"] != 1 or proc.returncode != 1:
        raise AssertionError(f"CLI disagrees: rc {proc.returncode}, {cli['summary']}, "
                             f"stderr {proc.stderr[-2000:]}")
    line("fleet", f"CLI fleet-scan --json on 2 DBs: {cli['summary']}, rc {proc.returncode}")

    # seconds per phase: the same steps fleet_scan takes, one at a time
    (names, states, counters, valid, _tr), t_load = sync_time(
        lambda: load_fleet_history(dbs, WINDOW_SECONDS, now=now))
    tensors, t_h2d = sync_time(lambda: packed_from_numpy(states, counters, valid, "cuda"))
    scan, t_kernel = sync_time(lambda: scan_links_packed(*tensors))
    classes, t_classify = sync_time(lambda: classify_links(scan).tolist())
    if not len(classes) == len(names) == hosts * LINKS_PER_HOST:
        raise AssertionError(f"{len(classes)} classes for {len(names)} links")
    phases = {"db_write_s": t_write, "load_fleet_history_s": t_load,
              "host_to_device_s": t_h2d, "kernel_s": t_kernel,
              "classify_s": t_classify, "fleet_scan_total_s": t_main}
    line("fleet", "seconds by phase: " + json.dumps(phases))
    return {"launches": launches, "phases": phases}


# -- 5. the device adapter and the GPU components ---------------------------------

# nvidia-smi's names for the fields NVML must reproduce exactly
SMI_FIELDS = (
    "name", "uuid", "pci.bus_id", "memory.total", "driver_version", "enforced.power.limit",
    "ecc.errors.corrected.volatile.total", "ecc.errors.uncorrected.volatile.total",
    "remapped_rows.correctable", "remapped_rows.uncorrectable", "remapped_rows.pending",
    "remapped_rows.failure", "temperature.gpu",
)
TEMPERATURE_TOLERANCE_C = 3
NVML_HEADER = Path("/usr/local/cuda/include/nvml.h")
ADAPTER_SAMPLES, ADAPTER_DOWN = 6, (3, 4)  # samples are numbered from 1


def smi(*args: str) -> str:
    return subprocess.run(["nvidia-smi", *args], capture_output=True, text=True,
                          timeout=60, check=True).stdout


def smi_rows() -> list:
    out = smi(f"--query-gpu={','.join(SMI_FIELDS)}", "--format=csv,noheader,nounits")
    return [dict(zip(SMI_FIELDS, (v.strip() for v in row.split(","))))
            for row in out.strip().splitlines()]


def smi_nvlink(index: int) -> dict:
    """link -> active, from ``nvidia-smi nvlink -s -i N``: a link line shows
    its speed when active and ``<inactive>`` when not."""
    links = {}
    for m in re.finditer(r"Link (\d+): (.*)", smi("nvlink", "-s", "-i", str(index))):
        links[int(m.group(1))] = "inactive" not in m.group(2).lower()
    return links


def absent(value: str) -> bool:
    return value in ("[N/A]", "N/A", "[Not Supported]")


def compare_with_smi(inst, devs: dict, tel: dict, rows: list) -> dict:
    """NVML's fields against nvidia-smi's, GPU by GPU: exact, but for the
    temperature. Where nvidia-smi shows no value, NVML must give none."""
    if len(rows) != len(devs):
        raise AssertionError(f"nvidia-smi lists {len(rows)} GPUs, NVML {len(devs)}")
    checked = {}
    for i, row in enumerate(rows):
        g, t = devs[i], tel[i]
        unsupported = set(t.unsupported) | set(t.errors) | set(g.unsupported) | set(g.errors)
        pending = "Yes" if t.memory_ecc_pending else "No"
        failed = "Yes" if t.remapping_failed else "No"
        pairs = {
            "name": (g.name, "name"),
            "uuid": (g.uuid, "uuid"),
            "pci.bus_id": (g.pci_address, "pci_bus_id"),
            "memory.total": (str(g.memory_total_bytes >> 20), "memory"),
            "driver_version": (inst.driver_version(), None),
            "enforced.power.limit": (f"{t.power_limit_w:.2f}", "power_limit"),
            "ecc.errors.corrected.volatile.total": (str(t.memory_ecc_correctable), "ecc_volatile"),
            "ecc.errors.uncorrected.volatile.total": (str(t.memory_ecc_uncorrectable),
                                                      "ecc_volatile"),
            "remapped_rows.correctable": (str(t.remapped_rows_correctable), "remapped_rows"),
            "remapped_rows.uncorrectable": (str(t.remapped_rows_uncorrectable), "remapped_rows"),
            "remapped_rows.pending": (pending, "remapped_rows"),
            "remapped_rows.failure": (failed, "remapped_rows"),
        }
        for key, (ours, nvml_field) in pairs.items():
            want = row[key]
            if absent(want):
                # no value from nvidia-smi: NVML must give none either
                ok = ours in ("", "0", "No", "0.00") and (
                    nvml_field is None or nvml_field in unsupported)
                if ok:
                    line("adapter", f"GPU {i} {key}: nvidia-smi {want}, NVML "
                                    f"{g.errors.get(nvml_field) or t.errors.get(nvml_field) or 'not supported'}")
            else:
                ok = ours == want
            if not ok:
                raise AssertionError(f"GPU {i} {key}: NVML {ours!r}, nvidia-smi {want!r}")
            checked[f"gpu{i}.{key}"] = want
        dt = abs(float(row["temperature.gpu"]) - t.temperature_c)
        if dt > TEMPERATURE_TOLERANCE_C:
            raise AssertionError(f"GPU {i} temperature: NVML {t.temperature_c}, "
                                 f"nvidia-smi {row['temperature.gpu']}")
        checked[f"gpu{i}.temperature.gpu"] = row["temperature.gpu"]
    return checked


def layout_program(path: Path) -> str:
    """C source that prints sizeof and offsetof of every struct the binding
    declares, and the value of every constant it uses, as nvml.h has them."""
    lines = ["#include <stddef.h>", "#include <stdio.h>", "#include <nvml.h>",
             "int main(void) {"]
    for cname, cls in nvml_mod.STRUCTS.items():
        lines.append(f'  printf("sizeof {cname} %zu\\n", sizeof({cname}));')
        for fname, _t in cls._fields_:
            lines.append(f'  printf("offsetof {cname}.{fname} %zu\\n", '
                         f"offsetof({cname}, {fname}));")
    for name in nvml_mod.CONSTANTS:
        lines.append(f'  printf("const {name} %lld\\n", (long long)({name}));')
    lines += ["  return 0;", "}"]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def check_layouts(workdir: Path) -> dict:
    """The ctypes structs and constants against the toolkit's nvml.h."""
    if not NVML_HEADER.is_file():
        line("adapter", f"{NVML_HEADER} is absent: the struct layouts and constants "
                        "were NOT checked against nvml.h")
        return {"header": None, "checked": 0}
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        raise RuntimeError("nvml.h is present but no C compiler (cc, gcc) is on PATH")
    src = layout_program(workdir / "nvml_layout.c")
    exe = workdir / "nvml_layout"
    proc = subprocess.run([cc, f"-I{NVML_HEADER.parent}", src, "-o", str(exe)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode:
        raise RuntimeError(f"{cc} failed on {src}:\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    got = {}
    for row in subprocess.run([str(exe)], check=True, capture_output=True, text=True,
                              timeout=60).stdout.splitlines():
        kind, name, value = row.split()
        got[(kind, name)] = int(value)
    want = {}
    for cname, cls in nvml_mod.STRUCTS.items():
        want[("sizeof", cname)] = ctypes.sizeof(cls)
        for fname, _t in cls._fields_:
            want[("offsetof", f"{cname}.{fname}")] = getattr(cls, fname).offset
    for name, value in nvml_mod.CONSTANTS.items():
        want[("const", name)] = value
    bad = {f"{k[0]} {k[1]}": (want[k], got.get(k)) for k in want if got.get(k) != want[k]}
    if bad:
        raise AssertionError(f"ctypes and nvml.h differ (ctypes, header): {bad}")
    line("adapter", f"nvml.h ({NVML_HEADER}): {len(nvml_mod.STRUCTS)} structs, "
                    f"{sum(1 for k in want if k[0] == 'offsetof')} field offsets and "
                    f"{len(nvml_mod.CONSTANTS)} constants equal the ctypes binding's")
    return {"header": str(NVML_HEADER), "checked": len(want)}


def host_ms(fn, reps=5) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check_scan(tel: dict, links: list, rows: list) -> dict:
    """``scan()`` on the card: every ported component reports; a healthy
    card shows what it must."""
    buf = io.StringIO()
    results = {r.component_name(): r for r in host_scan(out=buf)}
    for row in buf.getvalue().splitlines():
        if row.strip():
            line("adapter", "scan | " + row)
    names = {"accelerator-gpu-counts", "accelerator-gpu-temperature",
             "accelerator-gpu-memory", "accelerator-gpu-power", "accelerator-gpu-nvlink"}
    reported = {n: {"health": r.health_state_type(), "reason": r.summary()}
                for n, r in results.items()}
    if not links:
        # no link state at all: the component must say it is not supported
        if "accelerator-gpu-nvlink" in results or not re.search(
                r"accelerator-gpu-nvlink\s+-\s+not supported", buf.getvalue()):
            raise AssertionError("NVML reports no link state, yet the NVLink check ran")
        names.discard("accelerator-gpu-nvlink")
        reported["accelerator-gpu-nvlink"] = {"health": None, "reason": "not supported"}
    if not names <= set(results):
        raise AssertionError(f"components without a result: {sorted(names - set(results))}")
    hot = [t.temperature_c for t in tel.values() if t.temperature_c >= 85.0]
    if hot or results["accelerator-gpu-temperature"].health_state_type() != HealthStateType.HEALTHY:
        raise AssertionError(f"temperature: {reported['accelerator-gpu-temperature']}, {hot}")
    counts = results["accelerator-gpu-counts"]
    if counts.extra_info["found"] != counts.extra_info["expected"]:
        raise AssertionError(f"GPU counts: {counts.extra_info}")
    faulty = any(int(r["ecc.errors.uncorrected.volatile.total"] or 0) > 0
                 for r in rows if not absent(r["ecc.errors.uncorrected.volatile.total"])) \
        or any(r["remapped_rows.pending"] == "Yes" for r in rows)
    if not faulty and results["accelerator-gpu-memory"].health_state_type() == HealthStateType.UNHEALTHY:
        raise AssertionError(f"memory unhealthy on a clean card: {reported['accelerator-gpu-memory']}")
    if links:
        reason = results["accelerator-gpu-nvlink"].summary()
        inactive = sorted(ln.name for ln in links if ln.state != gpu_instance.LinkState.UP)
        named = sorted(set(re.findall(r"gpu\d+/nvlink\d+", reason)))
        if named != inactive:
            raise AssertionError(f"NVLink reason names {named}, NVML reports inactive {inactive}")
        if not inactive and not reason.startswith(f"all {len(links)}/"):
            raise AssertionError(f"NVLink reason {reason!r} with every link active")
    return reported


def store_into_fleet_scan(workdir: Path, base, window: float = 3600.0) -> dict:
    """Six one-minute samples of the card's links, ``gpu0/nvlink0`` injected
    down in samples 3-4, through ``NVLinkStore`` into ``fleet_scan``."""
    source = "nvml"
    if not base.nvlink_links():
        source = "mock"
        line("adapter", "NVML reports no NVLink link state on this card: the store takes "
                        "MockBackend's links (same kernel, same card)")
        base = gpu_instance.MockBackend(accelerator_type=f"h100-sxm-{len(base.devices())}")
    inj = FailureInjector()
    inst = gpu_instance.InjectedInstance(base, inj)
    db_path = workdir / "nvlink_host.db"
    db = DB(str(db_path))
    store = NVLinkStore(db)
    now = float(int(time.time()))
    store.time_now_fn = lambda: now
    for k in range(1, ADAPTER_SAMPLES + 1):
        inj.nvlink_links_down = ["gpu0/nvlink0"] if k in ADAPTER_DOWN else []
        store.insert_snapshot(inst.nvlink_links(), ts=now - STEP_SECONDS * (ADAPTER_SAMPLES - k))
    ref = store.scan(window)
    db.close()

    captured = []
    real = fleet_scan_mod.scan_links_packed

    def recording(*args):
        out = real(*args)
        captured.append(out)
        return out

    scan_links_packed.launches = 0
    fleet_scan_mod.scan_links_packed = recording
    try:
        res = fleet_scan([str(db_path)], window_seconds=window, now=now)
    finally:
        fleet_scan_mod.scan_links_packed = real
    launches = scan_links_packed.launches
    if launches != 1:
        raise AssertionError(f"fleet_scan over the NVLink store launched the kernel {launches} times")
    names = load_fleet_history([str(db_path)], window, now=now)[0]
    got = {f: getattr(captured[0], f).cpu().tolist() for f in captured[0]._fields}
    host = db_path.stem + "/"
    mismatches = []
    for i, name in enumerate(names):
        r = ref.links[name[len(host):]]
        ours = (got["drops"][i], got["flaps"][i], bool(got["currently_down"][i]),
                got["samples"][i], got["counter_delta"][i])
        want = (r.drops, r.flaps, r.currently_down, r.samples, r.crc_delta)
        if ours != want:
            mismatches.append((name, ours, want))
    if mismatches or len(names) != len(ref.links):
        raise AssertionError(f"fleet_scan vs NVLinkStore.scan: {mismatches[:5]}, "
                             f"{len(names)} vs {len(ref.links)} links")
    flapped = ref.links["gpu0/nvlink0"]
    if (flapped.drops, flapped.flaps, flapped.currently_down) != (1, 1, False):
        raise AssertionError(f"gpu0/nvlink0: {flapped}")
    cpu = fleet_scan([str(db_path)], window_seconds=window, now=now, device="cpu")
    if cpu["links"] != res["links"]:
        raise AssertionError("fleet_scan classes differ between the card and device='cpu'")
    line("adapter", f"NVLinkStore ({source} links): {ADAPTER_SAMPLES} samples, "
                    f"{len(names)} links -> fleet_scan: {launches} launch, {res['summary']}; "
                    "drops, flaps, currently-down, samples and CRC deltas equal "
                    "NVLinkStore.scan; classes equal device='cpu'")
    return {"nvlink_source": source, "links": len(names), "launches": launches,
            "summary": res["summary"], "gpu0/nvlink0": res["links"][host + "gpu0/nvlink0"]}


def phase_adapter(workdir: Path) -> dict:
    t_phase = time.perf_counter()
    for env in (gpu_instance.ENV_MOCK_ALL_SUCCESS, gpu_instance.ENV_USE_TORCH):
        os.environ.pop(env, None)
    t0 = time.perf_counter()
    inst = gpu_instance.new_instance()
    t_open = (time.perf_counter() - t0) * 1e3
    if not isinstance(inst, gpu_instance.NVMLBackend) or not inst.gpu_lib_exists():
        raise RuntimeError(f"new_instance() gave {type(inst).__name__}, "
                           f"init error {inst.init_error()!r}")
    devs, tel, links = inst.devices(), inst.telemetry(), inst.nvlink_links()
    t_sample = host_ms(lambda: (inst.telemetry(), inst.nvlink_links()))
    line("adapter", f"NVMLBackend: {inst.product_name()}, {inst.accelerator_type()}, driver "
                    f"{inst.driver_version()}, CUDA {inst.runtime_version()}; open {t_open:.3f} ms, "
                    f"one sample (telemetry + links) {t_sample:.3f} ms host")
    for gid, t in sorted(tel.items()):
        line("adapter", f"gpu{gid}: {t.temperature_c:.0f} C (memory {t.memory_temperature_c:.0f} C), "
                        f"{t.power_w:.1f} / {t.power_limit_w:.2f} W, SM {t.clock_mhz:.0f} MHz, "
                        f"util {t.duty_cycle_pct:.0f} %, ECC volatile {t.memory_ecc_correctable}/"
                        f"{t.memory_ecc_uncorrectable}, reasons {t.clock_event_reasons:#x}; "
                        f"unsupported {sorted(set(t.unsupported))}, errors {t.errors}")
    rows = smi_rows()
    checked = compare_with_smi(inst, devs, tel, rows)
    line("adapter", f"NVML equals nvidia-smi on {len(checked)} fields "
                    f"(temperature within {TEMPERATURE_TOLERANCE_C} C)")
    nvlink = {}
    for gid in sorted(devs):
        ours = {ln.link_id: ln.state == gpu_instance.LinkState.UP
                for ln in links if ln.gpu_id == gid}
        theirs = smi_nvlink(gid)
        if ours != theirs:
            raise AssertionError(f"GPU {gid} NVLink: NVML {ours}, nvidia-smi {theirs}")
        nvlink[f"gpu{gid}"] = {"links": len(ours), "active": sum(ours.values())}
    line("adapter", f"NVLink equals nvidia-smi nvlink -s: {nvlink}")
    layouts = check_layouts(workdir)

    os.environ[gpu_instance.ENV_USE_TORCH] = "1"
    try:
        tb = gpu_instance.new_instance()
    finally:
        del os.environ[gpu_instance.ENV_USE_TORCH]
    tdevs = tb.devices()
    if not isinstance(tb, gpu_instance.TorchBackend) or \
            [g.name for _i, g in sorted(tdevs.items())] != [g.name for _i, g in sorted(devs.items())]:
        raise AssertionError(f"TorchBackend {type(tb).__name__}: {tdevs} against NVML {devs}")
    line("adapter", f"TorchBackend: {len(tdevs)} device(s), names equal NVML's")

    components = check_scan(tel, links, rows)
    store = store_into_fleet_scan(workdir, inst)
    rec = {"backend": type(inst).__name__, "product": inst.product_name(),
           "accelerator_type": inst.accelerator_type(), "driver": inst.driver_version(),
           "cuda": inst.runtime_version(), "open_ms": t_open, "sample_ms": t_sample,
           "smi_fields_equal": len(checked), "nvlink": nvlink, "layouts": layouts,
           "torch_backend_devices": len(tdevs), "components": components, **store,
           "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"adapter": rec}), flush=True)
    return rec


# -- 6. analytics ---------------------------------------------------------------

# the robust scorer at fleet scale: 2048 eight-GPU hosts (16384 GPUs) swept
# in one call, T = 180 samples (the anomaly component's MAX_WINDOW_SAMPLES),
# F = 8 features (N_FEATURES): 94 MB of float32, beyond the L2
FLEET_CHIPS, FLEET_T, FLEET_F, DRIFTING = 16384, 180, 8, 16
ENTRY_CFG = AEConfig(window=16, features=8, hidden=256, latent=32)


def ae_flop_per_sample(cfg: AEConfig) -> int:
    """Multiply-adds of the four products, two flop each (81 920 at the
    entry width)."""
    d, h, z = cfg.input_dim, cfg.hidden, cfg.latent
    return 2 * (d * h + h * z + z * h + h * d)


def ae_param_bytes(cfg: AEConfig) -> int:
    d, h, z = cfg.input_dim, cfg.hidden, cfg.latent
    return 4 * (d * h + h + h * z + z + z * h + h + h * d + d)


def roofline(nbytes: int, flop: int) -> dict:
    """Least time for the work: bytes over the HBM rate or float32 flop
    over the non-tensor float32 peak, whichever is longer."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flop / PEAK_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flop": flop}


def kernel_profile(fn, args, calls=10) -> dict:
    """torch.profiler over ``calls`` calls of ``fn(*args)``: device
    activities (kernels, memsets, copies) per call, their device ms per
    call, and the three that take the most time. None where the profiler
    records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]

    def us(e):  # self_device_time_total since torch 2.4, self_cuda_time_total before
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    if not rows:
        return {"kernels_per_call": None, "profiler_ms": None, "top_kernels": None}
    rows.sort(key=us, reverse=True)
    return {
        "kernels_per_call": sum(e.count for e in rows) / calls,
        "profiler_ms": sum(us(e) for e in rows) / calls / 1e3,
        "top_kernels": [{"name": e.key[:120], "ms_per_call": us(e) / calls / 1e3,
                         "count_per_call": e.count / calls} for e in rows[:3]],
    }


def wall_ms(fn, args, reps=7) -> float:
    """Median host milliseconds of one synchronised call: what a caller
    that waits for the result pays, launches included."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_abs(a, b) -> float:
    return float((a.detach().cpu().double() - b.detach().cpu().double()).abs().max())


def phase_analytics() -> dict:
    out = {}
    rng = np.random.default_rng(SEED + 2)
    C, T, F = FLEET_CHIPS, FLEET_T, FLEET_F

    # robust scorer over the fleet: 16 chips whose temperature ramps 40
    # degrees over their last 16 samples (tests/test_jax_analytics.py's drift)
    w = rng.normal(50.0, 0.5, size=(C, T, F)).astype(np.float32)
    drifting = np.sort(rng.choice(C, DRIFTING, replace=False))
    w[drifting, T - 16:, 0] += np.linspace(0, 40, 16, dtype=np.float32)
    windows = torch.from_numpy(w).to("cuda")
    scores, t_scores = sync_time(lambda: robust_scores(windows))
    top = np.sort(torch.topk(scores, DRIFTING).indices.cpu().numpy())
    if not np.array_equal(top, drifting):
        raise AssertionError(f"top {DRIFTING} scores {top.tolist()} != drifting {drifting.tolist()}")
    t0 = time.perf_counter()
    ref = robust_scores_np(w)
    t_np = time.perf_counter() - t0
    got = scores.cpu().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4,
                               err_msg="robust_scores vs robust_scores_np")
    out["robust_scores"] = {
        "shape": [C, T, F], "first_call_s": t_scores, "numpy_twin_host_s": t_np,
        "max_abs_err_vs_numpy": float(np.abs(got - ref).max()),
        "drifting_top": True, "min_drifting_score": float(got[drifting].min()),
        "max_other_score": float(np.delete(got, drifting).max()),
    }
    line("analytics", f"robust_scores {C}x{T}x{F}: the {DRIFTING} drifting chips score top "
                      f"{DRIFTING}; max |card - numpy twin| "
                      f"{out['robust_scores']['max_abs_err_vs_numpy']:.3g} (rtol = atol = 1e-4)")

    # entry() on the card against the same call on the CPU
    fn, (params, batch) = entry()
    _, (params_cpu, batch_cpu) = entry(device="cpu")
    s64 = fn(params, batch)
    np.testing.assert_allclose(s64.cpu().numpy(), fn(params_cpu, batch_cpu).numpy(),
                               rtol=1e-5, atol=0, err_msg="ae_scores batch 64, card vs cpu")
    fleet_batch = windows_to_batch(windows[:, -ENTRY_CFG.window:, :])
    s_fleet = ae_scores(params, fleet_batch)
    if s_fleet.shape != (C,) or not bool(torch.isfinite(s_fleet).all()):
        raise AssertionError(f"fleet ae_scores: shape {tuple(s_fleet.shape)} or not finite")
    # raw telemetry (about 50) makes large pre-activations, whose rounding
    # to bf16 flips where the card's float32 sums differ from the CPU's in
    # the last bit: on the CPU, float64-accumulated products moved these
    # scores by up to 4.9e-4 relative, hence rtol 2e-3 here (1e-5 above,
    # on the entry's N(0, 1) batch, where the same test moved them 7e-7)
    s_fleet_cpu = ae_scores(params_cpu, fleet_batch.cpu())
    np.testing.assert_allclose(s_fleet.cpu().numpy(), s_fleet_cpu.numpy(), rtol=2e-3,
                               atol=0, err_msg="ae_scores batch 16384, card vs cpu")
    rel = lambda a, b: ((a.cpu() - b) / b).abs()  # noqa: E731
    out["entry"] = {
        "batch": list(batch.shape), "fleet_batch": list(fleet_batch.shape),
        "max_rel_err_vs_cpu_b64": float(rel(s64, fn(params_cpu, batch_cpu)).max()),
        "max_rel_err_vs_cpu_fleet": float(rel(s_fleet, s_fleet_cpu).max()),
        "median_rel_err_vs_cpu_fleet": float(rel(s_fleet, s_fleet_cpu).median()),
    }
    line("analytics", f"entry(): ae_scores equal device='cpu' at batch 64 (max rel "
                      f"{out['entry']['max_rel_err_vs_cpu_b64']:.3g}, rtol 1e-5) and at batch "
                      f"{C} (max rel {out['entry']['max_rel_err_vs_cpu_fleet']:.3g}, rtol 2e-3)")

    # 60 steps at entry width, lr 1e-2: the loss falls and a x8 sample stands out
    p, losses = params, []
    for _ in range(60):
        p, loss = ae_train_step(p, batch, lr=1e-2)
        losses.append(float(loss))
    anomalous = batch.clone()
    anomalous[0] *= 8.0
    sc = ae_scores(p, anomalous).cpu().numpy()
    if not losses[-1] < losses[0]:
        raise AssertionError(f"60 steps: loss {losses[0]} -> {losses[-1]} did not fall")
    if not sc[0] > 2 * np.median(sc):
        raise AssertionError(f"x8 sample scores {sc[0]}, median {np.median(sc)}")
    # one step on the card against one on the CPU, from the same parameters
    new, loss = ae_train_step(params, batch, lr=1e-3)
    new_cpu, loss_cpu = ae_train_step(params_cpu, batch_cpu, lr=1e-3)
    perr = max(max_abs(a, b) for a, b in zip(new, new_cpu))
    if perr > 1e-6:
        raise AssertionError(f"train step: card params differ from cpu by {perr}")
    np.testing.assert_allclose(float(loss), float(loss_cpu), rtol=1e-5, atol=0,
                               err_msg="train step loss, card vs cpu")
    out["train"] = {"loss_first": losses[0], "loss_60": losses[-1],
                    "x8_score_over_median": float(sc[0] / np.median(sc)),
                    "step_max_abs_err_vs_cpu": perr}
    line("analytics", f"60 steps: loss {losses[0]:.5f} -> {losses[-1]:.5f}; x8 sample "
                      f"{out['train']['x8_score_over_median']:.1f} x the median; one step "
                      f"within {perr:.3g} of the cpu's")

    # the multichip dry run on one card, over NCCL
    res, t_dry = sync_time(lambda: dryrun_multichip(1))
    cfg1 = AEConfig(window=4, features=8, hidden=16, latent=8)
    p1 = ae_init(cfg1, torch.Generator().manual_seed(0), device="cpu")
    w1 = np.random.default_rng(0).normal(size=(4, 4, 8)).astype(np.float32)
    new1, loss1 = ae_train_step(p1, windows_to_batch(torch.from_numpy(w1)))
    derr = max(max_abs(res["params"][n], t) for n, t in zip(AEParams._fields, new1))
    if derr > 1e-6 or abs(res["loss"] - float(loss1)) > 1e-6 or res["mesh"] != (1, 1):
        raise AssertionError(f"dryrun_multichip(1): mesh {res['mesh']}, loss {res['loss']} "
                             f"vs {float(loss1)}, params off by {derr}")
    out["dryrun_multichip_1"] = {"seconds": t_dry, "summary": res["summary"],
                                 "loss": res["loss"], "params_max_abs_err_vs_cpu": derr}
    line("analytics", f"dryrun_multichip(1) over NCCL: {t_dry:.1f} s, {res['summary']}, "
                      f"step within {derr:.3g} of the cpu's")

    # device time per call, beside the bound
    cpm = spin_cycles_per_ms()
    flop = ae_flop_per_sample(ENTRY_CFG)
    pbytes, d = ae_param_bytes(ENTRY_CFG), ENTRY_CFG.input_dim
    calls = {
        f"robust_scores {C}x{T}x{F}": (
            robust_scores, (windows,), roofline(C * T * F * 4 + C * 4, 0),
            "input read once, scores written once, over 3.35 TB/s"),
        "ae_scores batch 64": (
            ae_scores, (params, batch), roofline(pbytes + 64 * d * 4 + 64 * 4, 64 * flop),
            "2 x B x 81920 flop over 67 TFLOP/s (float32, no tensor cores)"),
        f"ae_scores batch {C}": (
            ae_scores, (params, fleet_batch), roofline(pbytes + C * d * 4 + C * 4, C * flop),
            "2 x B x 81920 flop over 67 TFLOP/s (float32, no tensor cores)"),
        "ae_train_step batch 64": (
            ae_train_step, (params, batch), roofline(2 * pbytes + 64 * d * 4 + 4, 3 * 64 * flop),
            "3 x 2 x B x 81920 flop (forward, two backward products) over 67 TFLOP/s"),
    }
    timing = {}
    for name, (f, args, bnd, basis) in calls.items():
        prof = kernel_profile(f, args)
        # a window queues at most about 800 launches behind the spin: past
        # the stream's launch queue (about 1000) the host would wait on the
        # device inside the window
        per_call = prof["kernels_per_call"] or 100
        calls_per_window = max(1, min(20, int(800 // per_call)))
        ms = median_ms(f, [args], cpm, batch=calls_per_window)
        rec = {"ms": ms, "calls_per_window": calls_per_window, "wall_ms": wall_ms(f, args),
               **prof, **bnd, "bound_basis": basis, "share_of_bound": bnd["bound_ms"] / ms}
        timing[name] = rec
        line("analytics", f"{name}: {ms:.5f} ms device, {rec['wall_ms']:.4f} ms host wall, "
                          f"{rec['kernels_per_call']} kernels/call, bound {bnd['bound_ms']:.6f} ms "
                          f"({bnd['bound_by']}), share {rec['share_of_bound']:.4f}")
    out["timing"] = timing
    return out


# -- 7. timings ---------------------------------------------------------------------

# The device spins this long per timed call before the window opens (the
# spin is doubled when it did not cover the host): the host's wrapper time
# (checks, allocation, the launch call) passes while the device is busy,
# and the events' window holds device work alone.
COVER_MS_PER_CALL = 0.5


def spin_cycles_per_ms() -> float:
    """Clock cycles per millisecond of ``torch.cuda._sleep``'s device spin."""
    torch.cuda._sleep(1_000_000)  # warm-up
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    torch.cuda._sleep(20_000_000)
    e1.record()
    e1.synchronize()
    return 20_000_000 / e0.elapsed_time(e1)


def median_ms(fn, arg_sets, cycles_per_ms, *, batch=20, reps=7, flush=None) -> float:
    """Median device milliseconds per call of ``fn(*args)``: each window
    between two CUDA events holds ``batch`` back-to-back calls, which take
    the tuples of ``arg_sets`` in turn; ``flush`` runs before each window.

    Before the first event the device spins, so that event fires only once
    the host has queued the whole batch: the window holds no host time. A
    window whose first event had fired before the host was done is dropped
    and the spin doubled.
    """
    calls = itertools.cycle(arg_sets)
    for args in arg_sets:  # warm-up
        fn(*args)
    torch.cuda.synchronize()
    cover = int(COVER_MS_PER_CALL * batch * cycles_per_ms)
    times = []
    while len(times) < reps:
        if flush is not None:
            flush()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cover)
        e0.record()
        for _ in range(batch):
            fn(*next(calls))
        e1.record()
        covered = not e0.query()
        e1.synchronize()
        if covered:
            times.append(e0.elapsed_time(e1) / batch)
        elif cover > 64 * COVER_MS_PER_CALL * batch * cycles_per_ms:
            raise RuntimeError("a device spin of 64 x the cover did not cover the host")
        else:
            cover *= 2
    return statistics.median(times)


def profiled_ms(fn, arg_sets, kernel: str, calls=20):
    """Mean device milliseconds of the kernels named ``*kernel*`` per call of
    ``fn(*args)`` over ``arg_sets`` in turn, from torch.profiler; None where
    it records no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for args in itertools.islice(itertools.cycle(arg_sets), calls):
            fn(*args)
        torch.cuda.synchronize()
    # device_time_total since torch 2.4, cuda_time_total before
    us = sum(e.device_time_total if hasattr(e, "device_time_total") else e.cuda_time_total
             for e in prof.key_averages() if kernel in e.key)
    return us / calls / 1e3 if us else None


def host_us_per_call(fn, args, calls=200) -> float:
    """Host microseconds to run ``fn(*args)`` (for a kernel: check, allocate,
    launch), the device left to run behind it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def bound(valid: np.ndarray):
    """Least time for the scan of these inputs: every valid flag read once,
    the state and counter of every valid sample read once, 5 results per
    link written; or the integer operations, if they take longer."""
    L, T = valid.shape
    n_valid = int(valid.sum())
    nbytes = L * T + n_valid * (BYTES_PER_SAMPLE - 1) + L * BYTES_PER_LINK_OUT
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_valid * OPS_PER_SAMPLE / PEAK_OPS_PER_S * 1e3
    return nbytes, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_timing() -> dict:
    rng = np.random.default_rng(SEED + 1)
    scratch = torch.zeros(4 * L2_BYTES, dtype=torch.uint8, device="cuda")
    # reading 200 MB evicts the 50 MB L2 and leaves it clean. Writing them
    # leaves 50 MB of dirty lines, whose write-back then lands inside the
    # next timed window: that figure is kept only beside older ones taken
    # after such a flush.
    flush = scratch.max
    write_flush = scratch.zero_
    cpm = spin_cycles_per_ms()
    line("timing", f"device spin: {cpm:.0f} cycles per ms, "
                   f"{COVER_MS_PER_CALL} ms per timed call before each window")
    # one launch alone in the window: a one-thread kernel shows what the
    # events and the start of any kernel add to the profiler's kernel span
    empty_ms = median_ms(torch.cuda._sleep, [(1,)], cpm, batch=1, reps=20)
    line("timing", f"an almost empty kernel alone between two events: {empty_ms:.5f} ms")
    shapes = {}
    for L, T in ((4608, T_DAY), (4608, MAX_STEPS)):
        # full histories, as a fleet that has sampled every minute has
        states, counters, valid = packed_case(rng, L, T, empty_rows=0.0)
        valid[:] = True
        inputs = packed_from_numpy(states, counters, valid, "cuda")
        nbytes, bound_ms, bound_by = bound(valid)
        # copies of the inputs, together over 4x the L2, taken in turn: each
        # call finds its inputs out of L2, with no flush between calls
        cold = [inputs] + [tuple(x.clone() for x in inputs)
                           for _ in range(-(-4 * L2_BYTES // nbytes))]
        warm = [inputs]
        kernel, plain = scan_links_packed, scan_links_packed_reference
        ms = median_ms(kernel, cold, cpm)
        prof_ms = profiled_ms(kernel, cold, "packed_scan_kernel")
        rec = {
            "ms": ms,
            "plain_ms": median_ms(plain, cold, cpm),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "bytes": nbytes,
            "gb_per_s": nbytes / ms / 1e6,
            "share_of_bound": bound_ms / ms,
            "profiler_ms": prof_ms,
            "profiler_over_events": prof_ms / ms if prof_ms else None,
            "ms_one_launch": median_ms(kernel, warm, cpm, batch=1, reps=20, flush=flush),
            "empty_kernel_ms": empty_ms,
            "ms_one_launch_write_flush": median_ms(kernel, warm, cpm, batch=1, reps=20,
                                                   flush=write_flush),
            "ms_warm_l2": median_ms(kernel, warm, cpm),
            "profiler_ms_warm_l2": profiled_ms(kernel, warm, "packed_scan_kernel"),
            "fits_in_l2": nbytes <= L2_BYTES,
            "host_us_per_call": host_us_per_call(kernel, inputs),
        }
        shapes[f"{L}x{T}"] = rec
        line("timing", f"{L}x{T}: kernel {ms:.5f} ms (events, inputs out of L2), "
                       f"{prof_ms} ms (torch.profiler), bound {bound_ms:.5f} ms, "
                       f"share {bound_ms / ms:.3f}")
        line("timing", f"{L}x{T}: wrapper host time {rec['host_us_per_call']:.2f} us per call")
        line("timing", f"{L}x{T}: " + json.dumps(rec))
    return shapes


def main() -> int:
    smi = phase_device()
    resources = phase_build()
    max_err = phase_kernel()
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_dbs_", dir=build_dir))
    try:
        fleet = phase_fleet(workdir)
        adapter = phase_adapter(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    analytics = phase_analytics()
    shapes = phase_timing()
    day = shapes[f"4608x{T_DAY}"]
    print(json.dumps({"analytics": {"card": smi, **analytics}}), flush=True)
    print(json.dumps({"kernels": [{
        "name": "packed_scan",
        "route": "cuda",
        "source": "gpud_tpu_torch/csrc/packed_scan.cu",
        "replaces": "gpud_tpu/ops/pallas_scan.py:48",
        "launches": fleet["launches"],
        "launches_by_path": {"fleet": fleet["launches"], "adapter": adapter["launches"]},
        "max_abs_err": max_err,
        "ms": day["ms"],
        "plain_ms": day["plain_ms"],
        "bound_ms": day["bound_ms"],
        "bound_by": day["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes this scan",
        "shapes": shapes,
        "exact": max_err == 0,
        "card": smi,
        "ptxas": resources["packed_scan_kernel"],
        "fleet_phases_s": fleet["phases"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
