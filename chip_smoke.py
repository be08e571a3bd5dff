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
             with ``NVLinkStore.scan`` and with ``device="cpu"``; GPU 0's
             NVLink error counters read through field values beside
             ``nvidia-smi nvlink -e`` (equal where both read), and the NVML
             calls and host ms of a sample with the per-link error-counter
             calls and with one field-values call per GPU; printed as the
             ``{"adapter": ...}`` line;
6. health - the health checks of this slice on the card: the anomaly
             check over a metrics store of one HGX host (8 GPUs x 180
             one-minute samples x 7 features, GPU 5 drifting), scored with
             the torch backend on the card and with numpy (the same GPU
             flagged, scores within rtol = atol = 1e-4; ``auto`` resolves to
             torch once CUDA is up), then its scan-mode burst of 8 live NVML
             samples (its scores on the card held to numpy on the same
             windows; its verdict printed, not gated); ``accelerator-gpu-processes`` must list this process
             as a holder of /dev/nvidiaN; the runtime units' states; every
             line of the Xid/SXid corpus (tests/torch_xid_corpus.py) alone
             through watcher -> syncer -> SQLite event store ->
             ``accelerator-gpu-error-kmsg`` (its entry's health and repair
             actions), the whole corpus at once and in scan mode, a reboot
             between an Xid 48 and its recurrence (HARDWARE_INSPECTION), an
             Xid 74 opening the NVLink check's fast-poll window, set-healthy;
             the machine's own /dev/kmsg where it may be read; host ms per
             check() by backend, robust_scores' device ms at 8 x 180 x 7 and
             the burst's NVML ms per sample; printed as the ``{"health": ...}``
             line;
7. host   - ``scan()``'s 22 checks on the card's machine: a result or "not
             supported" for each; the CPU, memory, disk and OS checks held
             against ``nproc``, ``free -b``, ``df -B1 /`` (within one block)
             and ``uname -r``; each host check's verdict, reason and host
             ms, the scan's wall seconds; the NFS check over a group of two
             under the workdir (2 members fresh, then 1/2 unhealthy once one
             member's file is removed); printed as the ``{"host": ...}``
             line. Nothing dials a public address (``no_public_network``):
             the network-latency check's edges are reported unreachable
             without a connection (its verdict is a host without egress's)
             and provider detection is not run (``no_public_network``);
8. analytics - the analytics plane on the card (torch ops, no hand kernel):
             ``robust_scores`` over a fleet of 16384 chips x 180 samples x 8
             features with 16 seeded drifting chips (they must score top
             16, and equal the numpy twin), ``entry()`` and the autoencoder
             at batch 64 and 16384 against ``device="cpu"``, 60 training
             steps (the loss must fall), one step against the CPU's,
             ``dryrun_multichip(1)`` over NCCL; then device ms, host ms,
             kernels per call and the top kernels of four calls beside
             their bounds, printed as the ``{"analytics": ...}`` line;
9. timing  - device time per call of the kernel and of its plain version
             at both shapes, beside the memory bound: CUDA events around
             batches of back-to-back calls on input copies that together
             exceed the L2, with a device spin that keeps the host's
             wrapper time out of the window; beside it the kernel's time
             from torch.profiler, one launch alone after an L2 flush, and
             the wrapper's host time per call;
10. daemon - (after the host phase) the daemon on NVML, in a child process
             that imports no torch, twice: with the predict, fabric and
             outbox planes off (the memory baseline), then on, their jobs
             every 2 s. Each run: one state DB, one write-behind writer shared
             by every store, the 22 checks registered and the supported ones
             scheduled every 2 s with the watchdog on, the metrics syncer and
             recorder, the remediation engine with its default empty enforce
             list and executors that refuse; an Xid 79 line through kmsg to an
             Unhealthy check, one ledger transition and one dry-run
             reboot_system audit row, each step's ms after the write;
             set-healthy (2 transitions); NVML gauges in the metrics table;
             RSS and CPU seconds per second over 20 s; per-check host ms,
             dispatch lag, writer commits; shutdown (flush, WAL checkpoint,
             close). With the planes on: every check scored in [0, 1] by the
             predict ticks, each predicted row a dry run; the fabric sweep
             over the card's NVLink ports from NVML, all up, nothing
             published, sweeps x ports rows; the outbox journal, reopened,
             one record per producer record by kind with seqs 1..N, replayed
             into a capture session through the wire codec and decoded back
             to it, then acked; host ms per predict tick, sweep and replay
             batch, publish-to-commit ms. VmRSS: the off run under its
             ceiling, the on run within PLANES_VMRSS_MB of it; the pages each
             dirtied within the budget. Then, here: integrity_check, a restart
             that adds no transition and keeps the outbox's watermarks, the
             CLI's history and remediation, fleet_scan on the card over the
             NVLink history the daemon wrote (one launch), and the native
             library (native.build()) against its Python twins, with µs per
             line and ms per scan of both; printed as the ``{"daemon": ...}``
             line.

The ``{"adapter": ...}``, ``{"health": ...}``, ``{"host": ...}``, ``{"daemon": ...}`` and
``{"analytics": ...}`` lines come before the ``{"kernels": [...]}``
record, which is the line before the last; the last line
is ``{"ok": true, "device": {...}}``. Any failure raises, so the script
exits non-zero without the ``ok`` line. Data comes from fixed seeds.
"""

from __future__ import annotations

import ctypes
import dataclasses
import errno
import importlib.util
import inspect
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
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from gpud_tpu_torch import fleet_scan as fleet_scan_mod  # noqa: E402
from gpud_tpu_torch import host as host_mod  # noqa: E402
from gpud_tpu_torch import native, netutil, procfs  # noqa: E402
from gpud_tpu_torch.components import base as base_mod  # noqa: E402
from gpud_tpu_torch.components.host_extra import NFSComponent  # noqa: E402
from gpud_tpu_torch.components.all import all_components  # noqa: E402
from gpud_tpu_torch.metrics.registry import DEFAULT_REGISTRY  # noqa: E402
from gpud_tpu_torch.providers import detect as provider_detect  # noqa: E402
from gpud_tpu_torch.api.v1.types import (  # noqa: E402
    Event,
    EventType,
    HealthStateType,
    RepairActionType,
)
from gpud_tpu_torch.components.base import FailureInjector, TpudInstance  # noqa: E402
from gpud_tpu_torch.components.gpu import anomaly as anomaly_mod  # noqa: E402
from gpud_tpu_torch.components.gpu import catalog  # noqa: E402
from gpud_tpu_torch.components.gpu.error_kmsg import GPUErrorKmsgComponent  # noqa: E402
from gpud_tpu_torch.components.gpu.nvlink import GPUNVLinkComponent  # noqa: E402
from gpud_tpu_torch.components.gpu.nvlink_store import NVLinkStore  # noqa: E402
from gpud_tpu_torch.components.gpu.runtime import (  # noqa: E402
    GPUProcessesComponent,
    GPURuntimeComponent,
)
from gpud_tpu_torch.eventstore import EventStore  # noqa: E402
from gpud_tpu_torch.health_history import HealthLedger  # noqa: E402
from gpud_tpu_torch.kmsg import deduper as kmsg_deduper  # noqa: E402
from gpud_tpu_torch.kmsg import watcher as kmsg_watcher  # noqa: E402
from gpud_tpu_torch.kmsg.syncer import SharedWatcher  # noqa: E402
from gpud_tpu_torch.kmsg.writer import KmsgWriter  # noqa: E402
from gpud_tpu_torch.metrics.store import MetricsStore  # noqa: E402
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
from gpud_tpu_torch.session.outbox import SessionOutbox  # noqa: E402
from gpud_tpu_torch.sqlite import DB  # noqa: E402



def no_public_network() -> None:
    """The script runs on card machines without egress and dials no public
    address: the network-latency check's edges (public DNS and cloud
    metadata) are reported unreachable without a connection attempt, which
    is what the check sees on a host without egress, and cloud provider
    detection (metadata services, then ip.guide) is not run."""
    netutil.measure_edges = lambda edges=None, timeout=2.0: {
        name: None for name, _host, _port in (edges or netutil.DEFAULT_EDGES)}
    provider_detect.detect = lambda timeout=5.0: provider_detect.DetectResult(provider="unknown")


no_public_network()  # before any phase, also when a phase is called alone

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


def fleet_scan_of_store(db_path: Path, ref, window: float, now: float):
    """``fleet_scan`` on the card over one host's NVLink store: it must launch
    the kernel once, its per-link outputs must equal ``ref`` (the store's own
    ``scan``), and its classes must equal ``device="cpu"``'s."""
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
    if mismatches or len(names) != len(ref.links) or not names:
        raise AssertionError(f"fleet_scan vs NVLinkStore.scan: {mismatches[:5]}, "
                             f"{len(names)} vs {len(ref.links)} links")
    cpu = fleet_scan([str(db_path)], window_seconds=window, now=now, device="cpu")
    if cpu["links"] != res["links"]:
        raise AssertionError("fleet_scan classes differ between the card and device='cpu'")
    return res, launches, names


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
    res, launches, names = fleet_scan_of_store(db_path, ref, window, now)
    flapped = ref.links["gpu0/nvlink0"]
    if (flapped.drops, flapped.flaps, flapped.currently_down) != (1, 1, False):
        raise AssertionError(f"gpu0/nvlink0: {flapped}")
    host = db_path.stem + "/"
    line("adapter", f"NVLinkStore ({source} links): {ADAPTER_SAMPLES} samples, "
                    f"{len(names)} links -> fleet_scan: {launches} launch, {res['summary']}; "
                    "drops, flaps, currently-down, samples and CRC deltas equal "
                    "NVLinkStore.scan; classes equal device='cpu'")
    return {"nvlink_source": source, "links": len(names), "launches": launches,
            "summary": res["summary"], "gpu0/nvlink0": res["links"][host + "gpu0/nvlink0"]}


# C1: the NVLink error counters, read through one nvmlDeviceGetFieldValues call
# per GPU (gpu/nvml.py DeviceReader.links) in place of five
# nvmlDeviceGetNvLinkErrorCounter calls per link
SMI_COUNTERS = {"Replay Errors": "replay", "Recovery Errors": "recovery", "CRC Errors": "crc"}
OLD_COUNTERS = (("replay", nvml_mod.NVML_NVLINK_ERROR_DL_REPLAY),
                ("recovery", nvml_mod.NVML_NVLINK_ERROR_DL_RECOVERY),
                ("crc_flit", nvml_mod.NVML_NVLINK_ERROR_DL_CRC_FLIT),
                ("crc_data", nvml_mod.NVML_NVLINK_ERROR_DL_CRC_DATA),
                ("ecc_data", nvml_mod.NVML_NVLINK_ERROR_DL_ECC_DATA))


def smi_nvlink_errors(index: int) -> dict:
    """(link, counter) -> value from ``nvidia-smi nvlink -e -i N``, None
    where it prints N/A."""
    out = {}
    for m in re.finditer(r"Link (\d+): ([A-Za-z ]+?): (\S+)", smi("nvlink", "-e", "-i", str(index))):
        counter = SMI_COUNTERS.get(m.group(2))
        if counter is not None:
            v = m.group(3)
            out[(int(m.group(1)), counter)] = int(v) if v.isdigit() else None
    return out


def links_by_error_counter(reader) -> list:
    """The link walk before field values, for the comparison: each link's
    state, then its five counters, one NVML call each."""
    out = []
    for link in range(nvml_mod.NVML_NVLINK_MAX_LINKS):
        try:
            reader.nvml.nvlink_active(reader.handle, link)
        except nvml_mod.NVMLError as e:
            if e.code == nvml_mod.NVML_ERROR_INVALID_ARGUMENT:
                break
            continue
        for name, counter in OLD_COUNTERS:
            reader.read(f"nvlink{link}_{name}", reader.nvml.nvlink_error_counter, link, counter)
        out.append(link)
    return out


class NVMLCalls:
    """Counts the binding's NVML calls, the refused ones, and the field-value
    entries and refused entries, while the ``with`` block runs."""

    def __init__(self, nvml) -> None:
        self.nvml = nvml
        self.calls = self.refused = self.fields = self.fields_refused = 0

    def __enter__(self):
        call, field_values = self.nvml._call, self.nvml.field_values

        def counted_call(name, *args):
            self.calls += 1
            try:
                return call(name, *args)
            except nvml_mod.NVMLError:
                self.refused += 1
                raise

        def counted_fields(handle, requests):
            arr = field_values(handle, requests)
            self.fields += len(requests)
            self.fields_refused += sum(fv.nvmlReturn != nvml_mod.NVML_SUCCESS for fv in arr)
            return arr

        self.nvml._call, self.nvml.field_values = counted_call, counted_fields
        return self

    def __exit__(self, *exc):
        del self.nvml._call, self.nvml.field_values  # the class's methods again


def sample_cost(inst, walk) -> dict:
    """NVML calls and host ms of one sample (telemetry + every GPU's links)
    with the link walk ``walk(reader)``."""
    def sample():
        inst.telemetry()
        for _gpu, handle in inst._handles():
            if handle is not None:
                walk(nvml_mod.DeviceReader(inst.nvml, handle))

    with NVMLCalls(inst.nvml) as n:
        sample()
    return {"calls": n.calls, "refused_calls": n.refused, "field_entries": n.fields,
            "refused_field_entries": n.fields_refused, "host_ms": host_ms(sample)}


def check_nvlink_counters(inst, smi_line: str) -> dict:
    """GPU 0's link counters through field values beside ``nvidia-smi nvlink
    -e``, equal where both read; the cost of a sample before and after."""
    handle = inst.nvml.handle(0)
    r = nvml_mod.DeviceReader(inst.nvml, handle)
    samples = r.links()
    theirs = smi_nvlink_errors(0)
    if {ln for ln, _c in theirs} != {s.link_id for s in samples}:
        raise AssertionError(f"nvidia-smi nvlink -e lists links {sorted({ln for ln, _c in theirs})}, "
                             f"NVML {[s.link_id for s in samples]}")
    compared, read, refused, mismatches = 0, 0, 0, []
    for s in samples:
        cells = []
        for counter, ours in (("replay", s.replays), ("recovery", s.recoveries),
                              ("crc", s.crc_errors), ("ecc_data", s.ecc_errors)):
            name = f"nvlink{s.link_id}_{counter}"
            got = None if name in r.unsupported or name in r.errors else ours
            read += got is not None
            refused += got is None
            want = theirs.get((s.link_id, counter)) if counter != "ecc_data" else None
            if got is not None and want is not None:
                compared += 1
                if got != want:
                    mismatches.append((name, got, want))
            shown = "refused" if got is None else str(got)
            cells.append(f"{counter} {shown}" + (
                "" if counter == "ecc_data" else f"/{'N/A' if want is None else want}"))
        line("adapter", f"gpu0/nvlink{s.link_id}: " + ", ".join(cells)
             + " (field values / nvidia-smi nvlink -e)")
    if mismatches:
        raise AssertionError(f"NVLink counters differ from nvidia-smi nvlink -e: {mismatches}")
    smi_read = sum(v is not None for v in theirs.values())
    before = sample_cost(inst, links_by_error_counter)
    after = sample_cost(inst, lambda reader: reader.links())
    if read:
        verdict = f"{read} counters read through field values"
    elif smi_read:
        verdict = (f"NVML refuses every NVLink error field value while nvidia-smi nvlink -e "
                   f"reads {smi_read}: C1 stays open")
    else:
        verdict = ("the card refuses every NVLink error field value and nvidia-smi nvlink -e "
                   "prints N/A for every counter: C1 stays open")
    line("adapter", f"C1: {verdict}; {compared} compared with nvidia-smi (equal), "
                    f"nvidia-smi read {smi_read} of {len(theirs)}; errors {r.errors}")
    for label, cost in (("before (5 error-counter calls per link)", before),
                        ("after (1 field-values call per GPU)", after)):
        line("adapter", f"NVML per sample {label}: {cost['calls']} calls, "
                        f"{cost['refused_calls']} refused, {cost['field_entries']} field entries "
                        f"({cost['refused_field_entries']} refused), {cost['host_ms']:.3f} ms host "
                        f"[{smi_line}]")
    return {"links": len(samples), "counters_read": read, "counters_refused": refused,
            "smi_read": smi_read, "smi_counters": len(theirs), "compared_equal": compared,
            "unsupported_fields": len(r.unsupported), "errors": r.errors,
            "before": before, "after": after, "open": read == 0}


def phase_adapter(workdir: Path, smi_line: str = "") -> dict:
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
    c1 = check_nvlink_counters(inst, smi_line)

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
           "smi_fields_equal": len(checked), "nvlink": nvlink, "layouts": layouts, "c1": c1,
           "torch_backend_devices": len(tdevs), "components": components, **store,
           "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"adapter": rec}), flush=True)
    return rec


# -- 6. health ---------------------------------------------------------------------

# one HGX host: 8 GPUs x the anomaly component's 180 one-minute samples x its
# 7 features; GPU 5's temperature ramps 40 C over its last 16 samples
# (tests/test_anomaly_component.py's drift)
HEALTH_GPUS, HEALTH_DRIFT_GPU, HEALTH_DRIFT_SAMPLES = 8, 5, 16
# an idle H100's telemetry, one value per feature of FEATURE_METRICS, and
# the noise around it
HEALTH_BASE = (45.0, 40.0, 120.0, 30.0, 20.0, 1980.0, 2.0e10)
HEALTH_NOISE = (0.5, 0.5, 5.0, 3.0, 3.0, 15.0, 1.0e8)
KMSG_WAIT_S = 30.0


def load_corpus():
    """tests/torch_xid_corpus.py: organic lines for every catalog entry and
    lines that must match nothing (plain data, importing nothing)."""
    spec = importlib.util.spec_from_file_location(
        "torch_xid_corpus", ROOT / "tests" / "torch_xid_corpus.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def telemetry_rows(now: float) -> list:
    rng = np.random.default_rng(SEED + 3)
    G, T = HEALTH_GPUS, anomaly_mod.MAX_WINDOW_SAMPLES
    F = len(anomaly_mod.FEATURE_METRICS)
    v = np.asarray(HEALTH_BASE) + rng.normal(size=(G, T, F)) * np.asarray(HEALTH_NOISE)
    v[HEALTH_DRIFT_GPU, T - HEALTH_DRIFT_SAMPLES:, 0] += np.linspace(0, 40, HEALTH_DRIFT_SAMPLES)
    return [(now - (T - t) * STEP_SECONDS, name, {"component": "telemetry", "gpu": str(g)},
             float(v[g, t, f]))
            for t in range(T) for g in range(G)
            for f, name in enumerate(anomaly_mod.FEATURE_METRICS)]


def drifting(cr) -> list:
    return sorted(k[3:-6] for k, v in cr.extra_info.items()
                  if k.endswith("_score") and float(v) >= anomaly_mod.DEFAULT_SCORE_DEGRADED)


def health_anomaly(workdir: Path, inst, cpm: float) -> dict:
    """The daemon's anomaly check over a metrics store, on the card and
    with numpy; then robust_scores' device time at that shape."""
    now = float(int(time.time()))
    db = DB(str(workdir / "metrics.db"))
    try:
        MetricsStore(db).record(telemetry_rows(now))
        tinst = TpudInstance(gpu_instance=inst, db_rw=db, event_store=EventStore(db))
        comps = {}
        for backend in ("torch", "numpy", "auto"):
            c = anomaly_mod.GPUAnomalyComponent(tinst)
            c.backend, c.time_now_fn = backend, (lambda: now)
            comps[backend] = c
        results = {b: c.check() for b, c in comps.items()}
        for b, cr in results.items():
            line("health", f"anomaly check, backend {b}: {cr.health}, {cr.reason}; "
                           f"resolved {cr.extra_info.get('backend')}")
        want = [str(HEALTH_DRIFT_GPU)]
        if any(cr.health != HealthStateType.DEGRADED or drifting(cr) != want
               for cr in results.values()):
            raise AssertionError(f"anomaly at 8 x 180 x 7: {[(b, cr.health, drifting(cr)) for b, cr in results.items()]}")
        if results["auto"].extra_info["backend"] != "torch":
            raise AssertionError("auto did not resolve to torch with CUDA initialised")
        gpus, w = comps["numpy"]._build_windows(now)
        if w.shape != (HEALTH_GPUS, anomaly_mod.MAX_WINDOW_SAMPLES, len(anomaly_mod.FEATURE_METRICS)):
            raise AssertionError(f"windows {w.shape}")
        s_torch, used = anomaly_mod._score_windows(w, "torch")
        s_np, _ = anomaly_mod._score_windows(w, "numpy")
        if used != "torch" or anomaly_mod._score_windows(w, "auto")[1] != "torch":
            raise AssertionError(f"the torch backend resolved to {used}")
        np.testing.assert_allclose(s_torch, s_np, rtol=1e-4, atol=1e-4,
                                   err_msg="anomaly scores, torch on the card vs numpy")
        err = float(np.abs(s_torch - s_np).max())
        check_ms = {b: host_ms(comps[b].check) for b in ("torch", "numpy")}
        build_ms = host_ms(lambda: comps["numpy"]._build_windows(now))
        score_ms = {b: host_ms(lambda b=b: anomaly_mod._score_windows(w, b)) for b in ("torch", "numpy")}
        x = torch.from_numpy(w).cuda()
        prof = kernel_profile(robust_scores, (x,))
        per_call = prof["kernels_per_call"] or 100
        cpw = max(1, min(20, int(800 // per_call)))
        G, T, F = w.shape
        bnd = roofline(G * T * F * 4 + G * 4, 0)
        dev = {"ms": median_ms(robust_scores, [(x,)], cpm, batch=cpw), "calls_per_window": cpw,
               "wall_ms": wall_ms(robust_scores, (x,)), **prof, **bnd}
        dev["share_of_bound"] = bnd["bound_ms"] / dev["ms"]
        line("health", f"anomaly 8x180x7: GPU {HEALTH_DRIFT_GPU} flagged by torch (card) and numpy, "
                       f"scores within {err:.3g} (rtol = atol = 1e-4); one check() "
                       f"{check_ms['torch']:.3f} ms host (torch), {check_ms['numpy']:.3f} ms (numpy); "
                       f"store read {build_ms:.3f} ms, scoring {score_ms['torch']:.3f} / "
                       f"{score_ms['numpy']:.3f} ms")
        line("health", f"robust_scores 8x180x7 on the card: {dev['ms']:.5f} ms device, "
                       f"{dev['wall_ms']:.4f} ms host wall, {dev['kernels_per_call']} kernels/call, "
                       f"bound {bnd['bound_ms']:.7f} ms ({bnd['bound_by']})")
    finally:
        db.close()

    return {"shape": list(w.shape), "drifting_gpu": HEALTH_DRIFT_GPU,
            "backends": {b: {"health": r.health, "resolved": r.extra_info.get("backend"),
                             "flagged": drifting(r)} for b, r in results.items()},
            "max_abs_err_torch_vs_numpy": err, "check_host_ms": check_ms,
            "store_read_host_ms": build_ms, "score_host_ms": score_ms,
            "robust_scores": dev}


def health_burst(inst) -> dict:
    """Scan mode's anomaly check: a burst of 8 live NVML samples, scored on
    the card. The gate is what the code computes: the component scored the
    burst's [G, 8, 7] windows with the torch backend, and those scores agree
    with the numpy twin on the same windows. The verdict itself is printed
    and not gated: it depends on what the live card read (PERF.md §6)."""
    sample_ms, scored = [], []
    real_tel, real_score = inst.telemetry, anomaly_mod._score_windows

    def timed():
        t0 = time.perf_counter()
        out = real_tel()
        sample_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def captured(windows, backend, device=None):
        scores, used = real_score(windows, backend, device)
        scored.append((windows, scores, used))
        return scores, used

    inst.telemetry, anomaly_mod._score_windows = timed, captured
    try:
        burst = anomaly_mod.GPUAnomalyComponent(TpudInstance(gpu_instance=inst))
        burst.backend = "torch"
        t0 = time.perf_counter()
        cr = burst.check()
        burst_s = time.perf_counter() - t0
    finally:
        del inst.telemetry
        anomaly_mod._score_windows = real_score
    line("health", f"burst (scan mode), backend torch: {cr.health}, {cr.reason}; {len(sample_ms)} "
                   f"NVML samples, {statistics.median(sample_ms):.3f} ms median "
                   f"({min(sample_ms):.3f}-{max(sample_ms):.3f}); check {burst_s:.3f} s with "
                   f"{burst.burst_interval_seconds} s between samples; {cr.extra_info}")
    shape = (len(inst.devices()), anomaly_mod.MIN_SAMPLES, len(anomaly_mod.FEATURE_METRICS))
    if len(scored) != 1 or scored[0][0].shape != shape or scored[0][2] != "torch" \
            or cr.extra_info.get("backend") != "torch" \
            or cr.extra_info.get("samples") != str(anomaly_mod.MIN_SAMPLES) \
            or len(sample_ms) != anomaly_mod.MIN_SAMPLES:
        raise AssertionError(f"burst: {len(scored)} scorings of "
                             f"{[w.shape for w, _, _ in scored]} (want {shape}), "
                             f"{len(sample_ms)} samples, {cr.extra_info}")
    w, s_torch, _ = scored[0]
    s_np = robust_scores_np(w)
    np.testing.assert_allclose(s_torch, s_np, rtol=1e-4, atol=1e-4,
                               err_msg="burst scores, torch on the card vs numpy")
    flagged = bool((s_torch >= burst.score_degraded).any())
    if (cr.health == HealthStateType.DEGRADED) != flagged:
        raise AssertionError(f"burst: {cr.health} with scores {s_torch.tolist()}")
    err = float(np.abs(s_torch - s_np).max())
    line("health", f"burst scores {[round(float(x), 4) for x in s_torch]} on the card, within "
                   f"{err:.3g} of numpy on the same windows (rtol = atol = 1e-4); verdict "
                   f"{cr.health} (printed, not gated)")
    if flagged:
        for i in np.flatnonzero(s_torch >= burst.score_degraded):
            line("health", f"burst gpu{i} samples by feature: {w[i].T.tolist()}")
    return {"health": cr.health, "reason": cr.reason, "samples": len(sample_ms),
            "nvml_sample_ms": sample_ms, "check_s": burst_s, "shape": list(w.shape),
            "scores": s_torch.tolist(), "max_abs_err_torch_vs_numpy": err}


def health_runtime(inst) -> dict:
    tinst = TpudInstance(gpu_instance=inst)
    procs = GPUProcessesComponent(tinst).check()
    mine = procs.extra_info.get(str(os.getpid()), "")
    line("health", f"processes: {procs.reason}; this process ({os.getpid()}) holds {mine or 'nothing'}")
    if not re.search(r"/dev/nvidia\d", mine):
        fds = sorted({os.readlink(f"/proc/self/fd/{fd}") for fd in os.listdir("/proc/self/fd")
                      if os.path.islink(f"/proc/self/fd/{fd}")
                      and os.readlink(f"/proc/self/fd/{fd}").startswith("/dev/")})
        raise AssertionError(f"this process is not a holder of /dev/nvidiaN: its /dev fds {fds}")
    rt = GPURuntimeComponent(tinst)
    units = {u: rt._systemd_is_active(u) for u in rt.units}
    cr = rt.check()
    line("health", f"runtime: systemctl is-active {units}; {cr.health}, {cr.reason}")
    if (cr.health == HealthStateType.UNHEALTHY) != ("failed" in units.values()):
        raise AssertionError(f"runtime {cr.health} with units {units}")
    return {"holder": mine, "holders": len(procs.extra_info), "processes_health": procs.health,
            "units": units, "runtime_health": cr.health, "runtime_reason": cr.reason}


def wait_for(cond, what: str) -> float:
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > KMSG_WAIT_S:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.001)
    return (time.perf_counter() - t0) * 1e3


def run_lines(inst, path: Path, lines: list, db_path: str = ":memory:"):
    """``lines`` through a watcher thread on ``path`` → the component's
    syncer → a SQLite event store → the component; returns the component
    once every record was delivered."""
    db = DB(db_path)
    es = EventStore(db)
    tinst = TpudInstance(gpu_instance=inst, event_store=es,
                         reboot_event_store=host_mod.RebootEventStore(es))
    comp = GPUErrorKmsgComponent(tinst)
    path.write_text("")
    writer = KmsgWriter(str(path))
    for ln in lines:
        writer.write(ln, priority=3)
    delivered = []
    w = kmsg_watcher.Watcher(lambda m: (comp.syncer.process(m), delivered.append(m)),
                             path=str(path), from_now=False, poll_timeout_ms=20)
    w.start()
    try:
        wait_for(lambda: len(delivered) == len(lines), f"{len(lines)} kmsg records")
    finally:
        w.close()
    return comp, db


def expected(name: str, gpu) -> tuple:
    e = catalog.lookup(name)
    acts = list(e.repair_actions)
    return (HealthStateType.UNHEALTHY if e.critical else HealthStateType.DEGRADED,
            f"{name}(GPU {gpu}) (x1)" if gpu is not None else f"{name} (x1)",
            None if acts == [RepairActionType.IGNORE_NO_ACTION_REQUIRED] else acts)


def health_xid(workdir: Path, inst) -> dict:
    corpus = load_corpus()
    bdf = catalog.bdf_map(inst.devices())
    line("health", f"PCI map from NVML: {bdf or 'empty (NVML gives no PCI info)'}")
    # every organic line alone, through the whole pipeline
    per_line, kmsg_file = [], workdir / "kmsg"
    for name, lines in corpus.ORGANIC.items():
        for ln in lines:
            comp, db = run_lines(inst, kmsg_file, [ln])
            cr = comp.check()
            got = (cr.health, cr.reason,
                   cr.suggested_actions.repair_actions if cr.suggested_actions else None)
            want = expected(name, catalog.match(ln, bdf).gpu_id)
            evs = comp.events(0)
            db.close()
            if got != want or [e.name for e in evs] != [name]:
                raise AssertionError(f"{ln!r}: {got}, events {[e.name for e in evs]}; want {want}")
            per_line.append(name)
    comp, db = run_lines(inst, kmsg_file, corpus.BENIGN)
    benign = comp.check()
    n_benign_events = len(comp.events(0))
    db.close()
    if benign.health != HealthStateType.HEALTHY or n_benign_events:
        raise AssertionError(f"benign lines: {benign.health} {benign.reason}, {n_benign_events} events")
    line("health", f"Xid/SXid corpus: {len(per_line)} organic lines of all {len(corpus.ORGANIC)} "
                   f"catalog entries, each alone through watcher -> syncer -> event store -> "
                   f"accelerator-gpu-error-kmsg, gave its entry's health and repair actions; "
                   f"{len(corpus.BENIGN)} lines of other devices matched nothing")

    # the whole corpus in one ring, and the same file read in scan mode
    everything = [ln for lines in corpus.ORGANIC.values() for ln in lines] + corpus.BENIGN
    comp, db = run_lines(inst, kmsg_file, everything, str(workdir / "xid.db"))
    daemon = comp.check()
    n_events = len(comp.events(0))
    db.close()
    old = os.environ.get(kmsg_watcher.ENV_KMSG_PATH)
    os.environ[kmsg_watcher.ENV_KMSG_PATH] = str(kmsg_file)
    try:
        scan_cr = GPUErrorKmsgComponent(TpudInstance(gpu_instance=inst)).check()
    finally:
        if old is None:
            del os.environ[kmsg_watcher.ENV_KMSG_PATH]
        else:
            os.environ[kmsg_watcher.ENV_KMSG_PATH] = old
    if n_events != len(per_line) or daemon.health != HealthStateType.UNHEALTHY or \
            (scan_cr.health, scan_cr.reason) != (daemon.health, daemon.reason):
        raise AssertionError(f"whole corpus: {n_events} events, {daemon.health}; scan mode "
                             f"{scan_cr.health} {scan_cr.reason!r} vs {daemon.reason!r}")
    line("health", f"whole corpus in one ring: {n_events} events, {daemon.health}, repair "
                   f"{daemon.suggested_actions.repair_actions}; scan mode "
                   f"({kmsg_watcher.ENV_KMSG_PATH}) gives the same health and reason")

    # a reboot between an Xid 48 (reboot threshold 1) and its recurrence,
    # then an Xid 74, on a live watcher that follows the file as the
    # daemon's does
    db = DB(str(workdir / "escalation.db"))
    es = EventStore(db)
    tinst = TpudInstance(gpu_instance=inst, event_store=es,
                         reboot_event_store=host_mod.RebootEventStore(es))
    nvlink = GPUNVLinkComponent(tinst)
    comp = GPUErrorKmsgComponent(tinst)
    kmsg_file.write_text("")
    shared = SharedWatcher(path=str(kmsg_file), from_now=False)
    shared.register(comp.syncer)
    shared.start()
    writer = KmsgWriter(str(kmsg_file))
    xid48 = corpus.ORGANIC["gpu_ecc_xid48"][0]
    recur = xid48.replace("pid=2714", "pid=4242")
    assert recur != xid48
    steps, latency_ms = {}, []

    def inject(ln):
        n = len(comp.events(0))
        writer.write(ln, priority=2)
        latency_ms.append(wait_for(lambda: len(comp.events(0)) == n + 1, ln))

    try:
        inject(xid48)
        steps["first"] = comp.check()
        window_before = nvlink.poll_interval()
        # an event's time is the boot time, read from /proc/uptime (10 ms
        # steps), plus the record's offset: keep the reboot clear of both
        time.sleep(0.1)
        es.bucket(host_mod.REBOOT_COMPONENT).insert(Event(
            component=host_mod.REBOOT_COMPONENT, time=time.time(), name=host_mod.EVENT_NAME_REBOOT,
            type=EventType.WARNING, message="reboot between the two Xid 48 lines"))
        steps["after reboot"] = comp.check()
        time.sleep(0.1)
        inject(recur)
        steps["recurrence"] = comp.check()
        inject(corpus.ORGANIC["gpu_nvlink_error"][0])
        steps["Xid 74"] = comp.check()
        window_after = nvlink.poll_interval()
        time.sleep(0.1)
        comp.set_healthy()
        steps["set healthy"] = comp.check()
    finally:
        shared.close()
        db.close()
    for k, cr in steps.items():
        line("health", f"escalation, {k}: {cr.health}, {cr.reason}, repair "
                       f"{cr.suggested_actions.repair_actions if cr.suggested_actions else None}")
    want = {
        "first": (HealthStateType.UNHEALTHY, [RepairActionType.REBOOT_SYSTEM,
                                              RepairActionType.HARDWARE_INSPECTION]),
        "after reboot": (HealthStateType.HEALTHY, None),
        "recurrence": (HealthStateType.UNHEALTHY, [RepairActionType.HARDWARE_INSPECTION]),
        "Xid 74": (HealthStateType.UNHEALTHY, [RepairActionType.HARDWARE_INSPECTION]),
        "set healthy": (HealthStateType.HEALTHY, None),
    }
    got = {k: (cr.health, cr.suggested_actions.repair_actions if cr.suggested_actions else None)
           for k, cr in steps.items()}
    if got != want or "recurred after 1 reboot(s)" not in steps["recurrence"].reason:
        raise AssertionError(f"escalation: {got}")
    if not window_after == nvlink.fast_poll_interval < window_before:
        raise AssertionError(f"NVLink poll interval {window_before} -> {window_after} after Xid 74")
    line("health", f"NVLink poll interval {window_before} s -> {window_after} s after the Xid 74 "
                   f"line; kmsg write to stored event {statistics.median(latency_ms):.2f} ms median")

    # the machine's own ring buffer
    try:
        fd = os.open(kmsg_watcher.DEFAULT_KMSG_PATH, os.O_RDONLY | os.O_NONBLOCK)
        os.close(fd)
        msgs = kmsg_watcher.read_all(kmsg_watcher.DEFAULT_KMSG_PATH)
    except OSError as e:
        dev = {"readable": False, "errno": errno.errorcode.get(e.errno, e.errno), "error": str(e)}
        line("health", f"/dev/kmsg: not readable here ({dev['errno']}: {e.strerror})")
    else:
        hits = [(m.message, hit.entry.name, hit.gpu_id) for m in msgs
                if (hit := catalog.match(m.message, bdf)) is not None]
        dev = {"readable": True, "lines": len(msgs), "matches": hits}
        line("health", f"/dev/kmsg: {len(msgs)} lines, {len(hits)} catalog matches")
        for h in hits:
            line("health", f"/dev/kmsg match: {h[1]} (GPU {h[2]}): {h[0]}")
    return {"entries": len(corpus.ORGANIC), "organic_lines": len(per_line),
            "benign_lines": len(corpus.BENIGN), "whole_corpus_events": n_events,
            "pci_map": {str(k): v for k, v in bdf.items()},
            "escalation": {k: {"health": h, "repair": a} for k, (h, a) in got.items()},
            "nvlink_poll_s": [window_before, window_after],
            "write_to_event_ms": latency_ms, "dev_kmsg": dev}


def phase_health(workdir: Path, smi: str) -> dict:
    t_phase = time.perf_counter()
    for env in (gpu_instance.ENV_MOCK_ALL_SUCCESS, gpu_instance.ENV_USE_TORCH):
        os.environ.pop(env, None)
    inst = gpu_instance.new_instance()
    launches_before = scan_links_packed.launches
    scan_links_packed.launches = 0
    rec = {"card": smi,
           "burst": health_burst(inst),
           "anomaly": health_anomaly(workdir, inst, spin_cycles_per_ms()),
           "runtime": health_runtime(inst),
           "xid": health_xid(workdir, inst)}
    # the health checks run no hand kernel
    rec["packed_scan_launches"] = scan_links_packed.launches
    scan_links_packed.launches = launches_before
    rec["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"health": rec}), flush=True)
    return rec


# -- 7. host checks -----------------------------------------------------------------

HOST_CHECKS = [c.NAME for c in all_components()[:13]]


def tool(*argv: str) -> str:
    return subprocess.run(list(argv), capture_output=True, text=True, timeout=60,
                          check=True).stdout


class CheckTimes:
    """Host ms of each component's ``check()`` while the block runs."""

    def __enter__(self):
        self.ms = {}
        self._real = real = base_mod.Component.check

        def timed(comp):
            t0 = time.perf_counter()
            try:
                return real(comp)
            finally:
                self.ms[comp.name()] = (time.perf_counter() - t0) * 1e3

        base_mod.Component.check = timed
        return self

    def __exit__(self, *exc):
        base_mod.Component.check = self._real


def disk_gauges(mount: str = "/") -> dict:
    """The disk check's total and used bytes for ``mount``, from its gauges."""
    out = {}
    for _ts, name, labels, value in DEFAULT_REGISTRY.gather(0):
        if labels.get("component") == "disk" and labels.get("mount_point") == mount:
            out[name] = value
    return out


def hold_host_checks(results: dict) -> dict:
    """The CPU, memory, disk and OS checks against tools that do not share
    their readers: nproc, free -b, df -B1 / and uname -r."""
    held = {}
    nproc = int(tool("nproc"))
    cores = int(results["cpu"].extra_info["logical_cores"])
    if cores != nproc:
        raise AssertionError(f"cpu check: {cores} logical cores, nproc {nproc}")
    held["cpu.logical_cores"] = (cores, nproc)
    free_total = next(int(row.split()[1]) for row in tool("free", "-b").splitlines()
                      if row.startswith("Mem:"))
    total = int(results["memory"].extra_info["total_bytes"])
    if total != free_total:
        raise AssertionError(f"memory check: total {total} B, free -b {free_total} B")
    held["memory.total_bytes"] = (total, free_total)
    df = tool("df", "-B1", "/").splitlines()[1].split()
    df_total, df_used = int(df[1]), int(df[2])
    block = os.statvfs("/").f_frsize
    g = disk_gauges("/")
    ours_total, ours_used = g["tpud_disk_total_bytes"], g["tpud_disk_used_bytes"]
    if abs(ours_total - df_total) > block or abs(ours_used - df_used) > block:
        raise AssertionError(f"disk check on /: size {ours_total}, used {ours_used}; "
                             f"df -B1 / {df_total}, {df_used} (one block is {block} B)")
    held["disk./.size_bytes"] = (ours_total, df_total)
    held["disk./.used_bytes"] = (ours_used, df_used)
    uname = tool("uname", "-r").strip()
    kernel = results["os"].extra_info["kernel_version"]
    if kernel != uname:
        raise AssertionError(f"os check: kernel {kernel!r}, uname -r {uname!r}")
    held["os.kernel_version"] = (kernel, uname)
    for key, (ours, theirs) in held.items():
        line("host", f"{key}: check {ours}, tool {theirs}")
    return held


def nfs_group_of_two(workdir: Path) -> dict:
    """Two members write to a group directory under the workdir (the
    reference's tests/test_multihost_nfs_e2e.py, without daemons): both read
    2 fresh members; with the membership pinned at 2, removing one member's
    file leaves the other 1/2 unhealthy."""
    group = workdir / "nfs-group"
    cfg = types.SimpleNamespace(nfs_group_dirs=[str(group)])
    a, b = (NFSComponent(TpudInstance(config=cfg, machine_id=m)) for m in ("host-a", "host-b"))
    key = f"{group}:members_fresh"
    first = [a.check(), b.check(), a.check()]  # a wrote first, then saw b
    if any(r.health_state_type() != HealthStateType.HEALTHY for r in first) or \
            [r.extra_info[key] for r in first] != ["1", "2", "2"]:
        raise AssertionError(f"nfs group of two: {[(r.summary(), r.extra_info) for r in first]}")
    for c in (a, b):
        c.group_configs[0].expected_members = 2
    (group / "host-a").unlink()
    after = b.check()
    if after.health_state_type() != HealthStateType.UNHEALTHY or \
            "1/2 members fresh" not in after.summary():
        raise AssertionError(f"nfs with host-a gone: {after.health_state_type()}, {after.summary()}")
    line("host", f"nfs: {first[1].summary()} ({key.replace(str(workdir), '<workdir>')} = 2); "
                 f"host-a's file removed: {after.health_state_type()}, "
                 f"{after.summary().replace(str(workdir), '<workdir>')}")
    return {"members_fresh": 2, "after_removal": after.health_state_type(),
            "reason_after_removal": after.summary().replace(str(workdir), "<workdir>")}


def phase_host(workdir: Path, smi_line: str, c1: dict) -> dict:
    """The 22-check ``scan()`` on the card's machine: a result or "not
    supported" for every check, the host checks held against tools, each
    check's host ms and the scan's wall seconds."""
    t_phase = time.perf_counter()
    for env in (gpu_instance.ENV_MOCK_ALL_SUCCESS, gpu_instance.ENV_USE_TORCH):
        os.environ.pop(env, None)
    launches_before = scan_links_packed.launches
    scan_links_packed.launches = 0
    buf = io.StringIO()
    with CheckTimes() as times:
        t0 = time.perf_counter()
        results = {r.component_name(): r for r in host_scan(out=buf)}
        wall_s = time.perf_counter() - t0
    text = buf.getvalue()
    for row in text.splitlines():
        if row.strip():
            line("host", "scan | " + row)
    names = [c.NAME for c in all_components()]
    unsupported = set(re.findall(r"^  (\S+)\s+-  not supported on this host$", text, re.M))
    missing = [n for n in names if n not in results and n not in unsupported]
    if len(names) != 22 or missing or set(results) & unsupported:
        raise AssertionError(f"scan: {len(names)} components, without a result {missing}")
    held = hold_host_checks(results)
    checks = {}
    for n in HOST_CHECKS:
        if n in results:
            r = results[n]
            checks[n] = {"health": r.health_state_type(), "reason": r.summary(),
                         "host_ms": times.ms[n]}
            line("host", f"{n}: {r.health_state_type()} | {r.summary()} | "
                         f"{times.ms[n]:.3f} ms host [{smi_line}]")
        else:
            checks[n] = {"health": None, "reason": "not supported"}
            line("host", f"{n}: not supported on this host")
    line("host", "network-latency: the edges were not dialled (no_public_network); "
                 "the verdict is a host without egress's")
    gpu_ms = {n: times.ms[n] for n in names[13:] if n in times.ms}
    line("host", f"scan(): {len(results)} checks, {len(unsupported)} not supported, "
                 f"{wall_s:.3f} s wall; GPU checks' host ms {json.dumps(gpu_ms)} [{smi_line}]")
    line("host", f"C1: NVLink error counters through field values: "
                 f"{'refused by the card, C1 open' if c1['open'] else 'read'}; NVML per sample "
                 f"{c1['before']['calls']} -> {c1['after']['calls']} calls, "
                 f"{c1['before']['host_ms']:.3f} -> {c1['after']['host_ms']:.3f} ms host")
    rec = {"card": smi_line, "scan_wall_s": wall_s, "checks": checks,
           "not_supported": sorted(unsupported), "gpu_check_host_ms": gpu_ms,
           "held_against_tools": held, "nfs": nfs_group_of_two(workdir), "c1": c1,
           "packed_scan_launches": scan_links_packed.launches,
           "phase_s": time.perf_counter() - t_phase}
    scan_links_packed.launches = launches_before
    print(json.dumps({"host": rec}), flush=True)
    return rec


# -- 10. daemon ------------------------------------------------------------------

# BASELINE.md: daemon RSS < 150 MB, held against the pages the daemon
# dirtied. VmRSS has a ceiling of its own just above the 225.2 MB measured on
# an H100 80GB HBM3 at 700 W, so any growth fails: the card's container counts
# every page of a mapped file resident once one is touched
# (``mapped_file_probe``), and NVML's init maps libcuda.so there, so VmRSS
# does not meet the 150 MB on that machine (ROADMAP C3).
DAEMON_RSS_BUDGET_MB = 150.0
DAEMON_VMRSS_CEILING_MB = 230.0
# the predict engine, the fabric sweep and the outbox may add this much VmRSS
# over the same child with them off, in the same run
PLANES_VMRSS_MB = 10.0
PROBE_FILE_MB = 16
NATIVE_T = T_DAY  # one host's day (144 links) for the ragged scan's timing
ERR_KMSG = GPUErrorKmsgComponent.NAME


def mapped_file_probe(workdir: str, size_mb: int = PROBE_FILE_MB) -> dict:
    """How this machine's kernel counts a mapped file in VmRSS: a file of
    ``size_mb`` written under ``workdir``, mapped read-only, one byte read.
    Linux counts the touched page and its readahead; a kernel that counts
    the whole mapping shows ``size_mb``. Runs on any Linux host."""
    import mmap as _mmap
    import os as _os

    def vmrss_kb():
        for row in open("/proc/self/status"):
            if row.startswith("VmRSS:"):
                return int(row.split()[1])
        raise AssertionError("no VmRSS in /proc/self/status")

    path = _os.path.join(workdir, "mapped_file_probe.bin")
    with open(path, "wb") as f:
        f.write(_os.urandom(size_mb << 20))
    fd = _os.open(path, _os.O_RDONLY)
    try:
        r0 = vmrss_kb()
        m = _mmap.mmap(fd, size_mb << 20, prot=_mmap.PROT_READ)
        r1 = vmrss_kb()
        _ = m[0]
        r2 = vmrss_kb()
        m.close()
    finally:
        _os.close(fd)
        _os.unlink(path)
    return {"file_mb": size_mb, "mapped_mb": (r1 - r0) / 1024.0,
            "one_byte_read_mb": (r2 - r0) / 1024.0}


def daemon_child(workdir: str, planes: str = "on") -> dict:
    """The daemon's core as ``Server`` composes it, without the server, on
    NVML: run in a child process that imports no torch (``phase_daemon``
    passes this function's source to ``python -c``, so it imports what it
    uses itself). With ``planes`` "on" the predict engine, the fabric sweep
    and the outbox run at the phase's 2 s and are gated; "off" is the core
    alone, for the memory baseline. Prints its lines and
    returns its record."""
    import json as _json
    import os
    import resource
    import sys as _sys
    import threading
    import time as _time
    from pathlib import Path as _Path

    from gpud_tpu_torch import native as _native
    from gpud_tpu_torch.components.base import _h_check_duration
    from gpud_tpu_torch.config import default_config
    from gpud_tpu_torch.daemon import Daemon
    from gpud_tpu_torch.fabric import plane as fabric_plane
    from gpud_tpu_torch.fault_injector import Injector, Request
    from gpud_tpu_torch.predict import engine as predict_engine
    from gpud_tpu_torch.process import RunResult
    from gpud_tpu_torch.scheduler import core as sched_core
    from gpud_tpu_torch.session import wire
    from gpud_tpu_torch.session.outbox import SessionOutbox
    from gpud_tpu_torch.sqlite import DB as _DB
    from gpud_tpu_torch.storage import checkpoint_wal

    err_kmsg = "accelerator-gpu-error-kmsg"
    poll_s = 2       # every check, the remediation scan and the metrics syncer
    steady_s = 20.0  # the window of steady-state RSS and CPU
    on = planes == "on"
    predicted = "predicted_warning"

    def say(msg):
        print(f"[daemon {planes}] {msg}", flush=True)

    def memory_mb():
        """VmRSS, and from /proc/self/smaps the pages this process dirtied
        (Private_Dirty + Shared_Dirty: heap, stacks, written data) and the
        clean pages of mapped files. The card's container reports every page
        of a mapped file resident (Rss equals the file's size, libcuda.so's
        94 MB included), so VmRSS there is not what Linux would count; the
        dirty pages are the daemon's own either way."""
        status = dict(row.split(":", 1) for row in
                      _Path("/proc/self/status").read_text().splitlines() if ":" in row)
        out = {"vmrss_mb": int(status["VmRSS"].split()[0]) / 1024.0,
               "dirty_mb": 0.0, "file_clean_mb": 0.0, "largest_files_mb": {}}
        name = None
        for row in _Path("/proc/self/smaps").read_text().splitlines():
            parts = row.split()
            if parts and "-" in parts[0] and not parts[0].endswith(":"):
                name = parts[5] if len(parts) > 5 else "[anon]"
            elif parts[:1] in (["Private_Dirty:"], ["Shared_Dirty:"]):
                out["dirty_mb"] += int(parts[1]) / 1024.0
            elif parts[:1] in (["Private_Clean:"], ["Shared_Clean:"]) and name.startswith("/"):
                kb = int(parts[1])
                out["file_clean_mb"] += kb / 1024.0
                out["largest_files_mb"][name] = out["largest_files_mb"].get(name, 0.0) + kb / 1024.0
        # each of the largest: its clean pages beside the file's size
        out["largest_files_mb"] = {
            _Path(f).name: [round(mb, 1), round(os.path.getsize(f) / 2**20, 1)]
            for f, mb in sorted(out["largest_files_mb"].items(), key=lambda kv: -kv[1])[:4]
            if os.path.exists(f)}
        return out

    def until(cond, what, timeout=60.0):
        t0 = _time.perf_counter()
        while not cond():
            if _time.perf_counter() - t0 > timeout:
                raise AssertionError(f"timed out waiting for {what}")
            _time.sleep(0.01)

    def pct(xs, q):
        xs = sorted(xs)
        return xs[min(len(xs) - 1, int(q * (len(xs) - 1) + 0.5))] if xs else 0.0

    class CaptureSession:
        """A connected session with no socket: ``send`` keeps the frame."""

        connected, auth_failed = True, False

        def __init__(self):
            self.frames = []

        def send(self, frame):
            self.frames.append(frame)
            return True

    def planes_after_stop(d, w, produced, warns, events_unjournaled):
        """The state DB reopened once the daemon stopped: the journal holds
        one record per producer record, by kind, seqs 1..N; the predict
        lane's rows are dry runs; a replay into a capture session, through
        the wire codec, decodes back to the journal; then the ack. The
        fabric table holds sweeps x links rows."""
        db = _DB(str(w / "tpud.state"))
        try:
            ob = SessionOutbox(db)
            journal = ob.pending(after=0)
            n = len(journal)
            kinds = {}
            for row in journal:
                kinds[row[2]] = kinds.get(row[2], 0) + 1

            def count(table, where=""):
                return db.query_one(f"SELECT COUNT(*) FROM {table} {where}")[0]

            expected = {"transition": count("tpud_health_transitions_v0_1"),
                        "event": count("tpud_events_v0_1") - events_unjournaled,
                        "remediation_audit": count("tpud_remediation_audit_v0_1"),
                        "predict_score": produced["predict_score"],
                        "ici_link": d.fabric.status()["published"]}
            if [r[0] for r in journal] != list(range(1, n + 1)) or ob.last_seq != n or \
                    set(kinds) - set(expected) or \
                    any(kinds.get(k, 0) != v for k, v in expected.items()) or \
                    any(kinds.get(k, 0) != v for k, v in produced.items()):
                raise AssertionError(f"outbox journal {kinds} over seqs 1..{ob.last_seq} "
                                     f"({n} rows); expected {expected}, produced {produced}")
            rows = db.query("SELECT component, decision, outcome FROM tpud_remediation_audit_v0_1 "
                            "WHERE action = 'predicted_warning' ORDER BY component")
            if [r[0] for r in rows] != sorted(warns) or \
                    any((r[1], r[2]) != ("dry_run", "dry_run") for r in rows):
                raise AssertionError(f"predicted rows {rows} for warnings {warns}")
            session, batch_ms = CaptureSession(), []
            while True:
                t0 = _time.perf_counter()
                if not ob.replay_once(session):
                    break
                batch_ms.append((_time.perf_counter() - t0) * 1e3)
            decoder, decoded = wire.DeltaDecoder(), []
            for frame in session.frames:
                batch = wire.parse_batch(wire.decode_payload(wire.encode_payload(frame.data)))
                decoded += [list(decoder.decode_record(r)) for r in batch["records"]]
            if decoded != [list(r) for r in journal]:
                raise AssertionError("the replayed records differ from the journal")
            ob.ack(n)
            if ob.backlog() or ob.acked_seq != n:
                raise AssertionError(f"after ack({n}): {ob.stats()}")
            fs = d.fabric.status()
            fabric_rows = count("tpud_fabric_matrix_v0_1")
            if fabric_rows != fs["sweeps"] * fs["links"] or fs["sweeps"] < 1:
                raise AssertionError(f"{fabric_rows} fabric rows for {fs['sweeps']} sweeps of "
                                     f"{fs['links']} links")
        finally:
            db.close()
        codec = "json" if wire._msgpack is None else "msgpack"
        say(f"outbox: {n} records {kinds}, seqs 1..{n}, one per producer record; "
            f"{len(rows)} predicted rows, all dry_run; replayed in {len(batch_ms)} batch(es) "
            f"through the {codec} codec, {[round(x, 3) for x in batch_ms]} host ms per batch, "
            f"decoded equal to the journal; acked {n}, backlog 0")
        say(f"fabric: {fabric_rows} rows = {fs['sweeps']} sweeps x {fs['links']} links")
        return {"outbox": {"records": n, "kinds": kinds, "predicted_rows": len(rows),
                           "replay_batches": len(batch_ms), "replay_batch_host_ms": batch_ms,
                           "acked_seq": n, "codec": codec},
                "fabric_rows": fabric_rows, "fabric_sweeps": fs["sweeps"]}

    w = _Path(workdir)
    rec = {"planes": planes, "vmrss_mb_at": {"imports": memory_mb()["vmrss_mb"]}}
    # the cuts: 2 s cadences for the checks, the scan, the syncer and, with
    # the planes on, the predict, calibrate, sweep and replay jobs
    cuts = dict(poll_interval_seconds=poll_s, remediation_interval_seconds=poll_s,
                scrape_interval_seconds=poll_s)
    if on:
        cuts.update(predict_interval_seconds=poll_s, predict_calibrate_interval_seconds=poll_s,
                    fabric_sweep_interval_seconds=poll_s, outbox_replay_interval_seconds=poll_s)
    else:
        cuts.update(predict_enabled=False, fabric_sweep_enabled=False, outbox_enabled=False)
    cfg = default_config(data_dir=str(w), kmsg_path=str(w / "kmsg"), **cuts)
    if cfg.validate() is not None:
        raise AssertionError(f"default config: {cfg.validate()}")
    bad = default_config(data_dir=str(w), scheduler_workers=0).validate()
    if bad != "scheduler workers must be >= 1":
        raise AssertionError(f"invalid config: {bad!r}")
    rec["config"] = {"validate": None, "invalid_message": bad}

    t_build = _time.perf_counter()
    d = Daemon(cfg)
    rec["vmrss_mb_at"]["construct"] = memory_mb()["vmrss_mb"]  # NVML's init included
    if on != all(p is not None for p in (d.predictor, d.fabric, d.outbox)):
        raise AssertionError(f"planes {planes}: {d.predictor}, {d.fabric}, {d.outbox}")
    # events journaled before the outbox was wired (the boot record) are in
    # the table only
    d.storage_writer.flush()
    events_unjournaled = d.db_rw.query_one("SELECT COUNT(*) FROM tpud_events_v0_1")[0] - (
        d.outbox.last_seq if on else 0)
    # the machine is never rebooted and no unit restarted: recorders that refuse
    calls = []

    def refuse_reboot():
        calls.append(["reboot"])
        return "refused: the daemon phase reboots nothing"

    def refuse_command(argv, timeout=0, env=None):
        calls.append(list(argv))
        return RunResult(exit_code=1, error="refused: the daemon phase restarts nothing")

    d.remediation.executors.reboot_fn = refuse_reboot
    d.remediation.executors.run_command_fn = refuse_command
    marks = {}
    transitions, audits = [], []
    tx_seen, audit_seen = threading.Event(), threading.Event()
    # what each producer handed the outbox, counted by the observers, which
    # call the outbox's hook (wired by the daemon) first
    produced = {"event": 0, "transition": 0, "remediation_audit": 0, "predict_score": 0,
                "ici_link": 0}
    warns = {}
    published_at = {}  # seq -> perf_counter at publish

    def chain(kind, prev, then=None):
        def hook(*a):
            if prev is not None:
                prev(*a)
            produced[kind] += 1
            if then is not None:
                then(*a)
        return hook

    def on_tx(comp, frm, to, ts, reason):
        transitions.append((comp, frm, to, reason, _time.perf_counter()))
        if comp == err_kmsg:
            tx_seen.set()

    def on_audit(row):
        audits.append((row, _time.perf_counter()))
        if row["component"] == err_kmsg and row["action"] != predicted:
            audit_seen.set()

    def on_predict(body):
        if body["event"] == "warn":
            warns[body["component"]] = warns.get(body["component"], 0) + 1

    d.event_store.on_insert = chain("event", d.event_store.on_insert)
    d.health_ledger.on_transition = chain("transition", d.health_ledger.on_transition, on_tx)
    d.remediation.audit.on_record = chain("remediation_audit", d.remediation.audit.on_record,
                                          on_audit)
    if on:
        d.predictor.on_publish = chain("predict_score", d.predictor.on_publish, on_predict)
        d.fabric.on_publish = chain("ici_link", d.fabric.on_publish)
        publish = d.outbox.publish

        def timed_publish(kind, payload, dedupe_key=""):
            seq = publish(kind, payload, dedupe_key=dedupe_key)
            published_at[seq] = _time.perf_counter()
            return seq

        d.outbox.publish = timed_publish
        job_ms = {"predict-calibrate": [], "session-outbox-replay": []}

        def timed(name, fn):
            def job():
                t0 = _time.perf_counter()
                try:
                    return fn()
                finally:
                    job_ms[name].append((_time.perf_counter() - t0) * 1e3)
            return job

        # bound before start(), where the scheduler takes them
        d.predictor.calibrate_now = timed("predict-calibrate", d.predictor.calibrate_now)
        d._outbox_replay_tick = timed("session-outbox-replay", d._outbox_replay_tick)
    # the reference's daemon leaves Config.poll_interval_seconds unread: each
    # check keeps its class's cadence, so the phase sets the 2 s here
    for comp in d.registry.all():
        if hasattr(comp, "POLL_INTERVAL"):
            comp.POLL_INTERVAL = float(poll_s)
    t_start = _time.perf_counter()
    d.start()
    ready = d.scheduler.wait_first_runs(timeout=60.0)
    if ready is None:
        raise AssertionError("first runs did not complete")
    rec["startup_ready_seconds"] = ready
    rec["startup_wall_seconds"] = _time.perf_counter() - t_start
    rec["construct_seconds"] = t_start - t_build
    comps = [c.name() for c in d.registry.all()]
    jobs = d.scheduler.job_names()
    comp_jobs = sorted(j[len("component:"):] for j in jobs if j.startswith("component:"))
    if len(comps) != 22 or comp_jobs != sorted(d.supported_names):
        raise AssertionError(f"{len(comps)} checks registered, jobs for {comp_jobs}")
    rec["checks_registered"] = len(comps)
    rec["checks_scheduled"] = len(comp_jobs)
    rec["not_supported"] = sorted(set(comps) - d.supported_names)
    rec["jobs"] = jobs
    say(f"{len(comps)} checks registered, {len(comp_jobs)} scheduled every {poll_s} s "
        f"(not supported here: {rec['not_supported']}); {len(jobs)} jobs; startup ready in "
        f"{ready:.4f} s")
    if d.gpu_instance.__class__.__name__ != "NVMLBackend":
        raise AssertionError(f"backend {d.gpu_instance.__class__.__name__}, not NVML")
    # two cycles of every scheduled check
    until(lambda: all(d.scheduler.get_job(f"component:{n}").runs >= 2
                      for n in comp_jobs if n != err_kmsg), "two check cycles")

    tx_seen.clear()
    audit_seen.clear()
    before = [t[:4] for t in transitions if t[0] == err_kmsg]
    if before:
        raise AssertionError(f"{err_kmsg} moved before the Xid: {before}")
    t_write = _time.perf_counter()  # the write's own time counts
    written = Injector(kmsg_path=str(w / "kmsg")).inject(Request(
        kernel_message="NVRM: Xid (PCI:0000:18:00): 79, pid='<unknown>', name=<unknown>, "
                       "GPU has fallen off the bus."))
    if not written.ok:
        raise AssertionError(f"kmsg write: {written.error}")
    if not tx_seen.wait(30.0):
        raise AssertionError("no transition after the Xid")
    tx_seen.clear()
    marks["ledger_transition_ms"] = (transitions[-1][-1] - t_write) * 1e3
    if on:
        # the Xid's records (its event, then its transition) from publish to
        # their commit by the write-behind writer, read on the daemon's
        # read-only connection
        seq = max(published_at)
        until(lambda: d.db_ro.query_one(
            "SELECT COUNT(*) FROM tpud_session_outbox_v0_1 WHERE seq = ?", (seq,))[0] == 1,
            "the transition's journal row", timeout=10.0)
        marks["publish_to_commit_ms"] = (_time.perf_counter() - published_at[seq]) * 1e3
    # the ledger observes a check before the check caches its result
    until(lambda: d.registry.get(err_kmsg).last_health_states()[0].health != "Healthy",
          "the check's cached result", timeout=10.0)
    marks["check_state_ms"] = (_time.perf_counter() - t_write) * 1e3
    state = d.registry.get(err_kmsg).last_health_states()[0]
    if state.health != "Unhealthy":
        raise AssertionError(f"{err_kmsg}: {state.health} ({state.reason}) after the Xid; "
                             f"transitions {[t[:4] for t in transitions]}")
    if not audit_seen.wait(30.0):
        raise AssertionError("no audit row after the Xid")
    marks["audit_row_ms"] = (audits[-1][-1] - t_write) * 1e3
    d.storage_writer.flush()
    marks["committed_ms"] = (_time.perf_counter() - t_write) * 1e3
    mine = [t for t in d.health_ledger.history(component=err_kmsg)]
    # the reactive rows; the predict lane's dry-run rows are held below
    rows = [r for r in d.remediation.audit.read(component=err_kmsg) if r["action"] != predicted]
    if [(t["from"], t["to"]) for t in mine] != [("Healthy", "Unhealthy")] or \
            [(r["action"], r["decision"], r["outcome"]) for r in rows] != \
            [("reboot_system", "dry_run", "dry_run")]:
        raise AssertionError(f"after the Xid: transitions {mine}, audit {rows}")
    say(f"Xid 79 -> {err_kmsg} {state.health} ({state.reason}): 1 transition "
        f"{marks['ledger_transition_ms']:.3f} ms after the kmsg write, 1 reboot_system row "
        f"decided dry_run {marks['audit_row_ms']:.3f} ms after it, committed at "
        f"{marks['committed_ms']:.3f} ms" + (
            f"; the transition's outbox record committed {marks['publish_to_commit_ms']:.3f} ms "
            f"after its publish" if on else ""))
    # another scan inside the cooldown: still one row
    scans = d.scheduler.get_job("remediation-scan").runs
    until(lambda: d.scheduler.get_job("remediation-scan").runs >= scans + 1, "a second scan")
    d.registry.get(err_kmsg).set_healthy()
    if not tx_seen.wait(30.0):
        raise AssertionError("no transition after set-healthy")
    d.storage_writer.flush()
    mine = d.health_ledger.history(component=err_kmsg)
    rows = [r for r in d.remediation.audit.read(component=err_kmsg) if r["action"] != predicted]
    if len(mine) != 2 or mine[0]["to"] != "Healthy" or len(rows) != 1:
        raise AssertionError(f"after set-healthy: transitions {mine}, audit {rows}")
    rec["transitions"] = [(t["from"], t["to"], t["reason"]) for t in reversed(mine)]
    rec["audit"] = [{k: r[k] for k in ("action", "suggested", "decision", "outcome", "detail")}
                    for r in rows]
    rec["other_transitions"] = [t[:4] for t in transitions if t[0] != err_kmsg]
    rec["other_audit_rows"] = [
        {k: r[k] for k in ("component", "action", "decision", "outcome")}
        for r, _ in audits if r["component"] != err_kmsg or r["action"] == predicted]
    say(f"set-healthy: 2 transitions {rec['transitions']}; other components: "
        f"{len(rec['other_transitions'])} transitions, {len(rec['other_audit_rows'])} audit rows "
        f"{rec['other_audit_rows']}")

    # the syncer's NVML gauges in the metrics table
    until(lambda: d.scheduler.get_job("metrics-syncer").runs >= 2, "two syncs")
    d.storage_writer.flush()
    gauges = {}
    for name in ("tpud_gpu_temperature_celsius", "tpud_gpu_power_watts",
                 "tpud_gpu_memory_used_bytes"):
        n, last = d.db_rw.query_one(
            "SELECT COUNT(*), MAX(value) FROM tpud_metrics_v0_1 WHERE name=?", (name,))
        if not n:
            raise AssertionError(f"no {name} rows in tpud_metrics_v0_1")
        gauges[name] = {"rows": n, "max": last}
    rec["metrics_rows"] = d.db_rw.query_one("SELECT COUNT(*) FROM tpud_metrics_v0_1")[0]
    rec["nvml_gauges"] = gauges
    say(f"metrics table: {rec['metrics_rows']} rows; {gauges}")

    # steady state: CPU seconds over the window, VmRSS sampled through it
    # (the container's /proc has no VmHWM, and getrusage's peak is the
    # parent's, inherited across exec)
    rss_samples = []
    ru0, t0 = resource.getrusage(resource.RUSAGE_SELF), _time.perf_counter()
    while _time.perf_counter() - t0 < steady_s:
        _time.sleep(0.5)
        rss_samples.append(int(_Path("/proc/self/statm").read_text().split()[1])
                           * resource.getpagesize() / 2**20)
    ru1, t1 = resource.getrusage(resource.RUSAGE_SELF), _time.perf_counter()
    cpu = (ru1.ru_utime + ru1.ru_stime - ru0.ru_utime - ru0.ru_stime) / (t1 - t0)
    mem = memory_mb()
    rec["steady"] = {"window_s": t1 - t0, "cpu_s_per_s": cpu, **mem,
                     "vmrss_peak_sampled_mb": max(rss_samples + [mem["vmrss_mb"]]),
                     "threads": threading.active_count()}
    rec["mapped_file_probe"] = mapped_file_probe(str(w))
    say(f"steady state over {t1 - t0:.3f} s: {cpu:.5f} CPU s per s; VmRSS {mem['vmrss_mb']:.1f} MB "
        f"(sampled peak {rec['steady']['vmrss_peak_sampled_mb']:.1f}; after the imports "
        f"{rec['vmrss_mb_at']['imports']:.1f}, after the construction {rec['vmrss_mb_at']['construct']:.1f}), "
        f"dirty (the daemon's own) {mem['dirty_mb']:.1f} MB, {mem['file_clean_mb']:.1f} MB clean "
        f"pages of mapped files, the largest [clean MB, file MB] {mem['largest_files_mb']}; "
        f"{rec['steady']['threads']} threads; one byte read of a mapped {PROBE_FILE_MB} MB file "
        f"adds {rec['mapped_file_probe']['one_byte_read_mb']:.3f} MB to VmRSS")

    # per-check host ms (the check-duration histogram), scheduler, writer
    sums, counts = {}, {}
    for _ts, name, labels, value in d.metrics_registry.gather(0):
        if name == _h_check_duration.name + "_sum":
            sums[labels["component"]] = value
        elif name == _h_check_duration.name + "_count":
            counts[labels["component"]] = value
    rec["check_host_ms"] = {c: sums[c] / counts[c] * 1e3 for c in sorted(counts) if counts[c]}
    lags = list(d.scheduler._lag_samples)
    st = d.scheduler.stats()
    rec["scheduler"] = {"workers": st["workers"], "jobs": st["jobs"],
                        "dispatch_lag_p50_ms": pct(lags, 0.5) * 1e3,
                        "dispatch_lag_p99_ms": pct(lags, 0.99) * 1e3, "dispatches": len(lags),
                        "watchdog_fires": sum(v for _k, v in sched_core._c_watchdog.labels_values())}
    ws = d.storage_writer.stats()
    flushes = list(d.storage_writer._flush_samples)
    rec["writer"] = {"commits": ws["commits"], "committed_ops": ws["committed_ops"],
                     "ops_per_commit": ws["committed_ops"] / max(1, ws["commits"]),
                     "flush_p50_ms": pct(flushes, 0.5) * 1e3, "flush_p99_ms": pct(flushes, 0.99) * 1e3,
                     "dropped": ws["dropped_ops"]}
    say(f"check host ms: {_json.dumps({k: round(v, 3) for k, v in rec['check_host_ms'].items()})}")
    say(f"scheduler: {rec['scheduler']}; writer: {rec['writer']}")
    if ws["dropped_ops"]:
        raise AssertionError(f"the writer dropped {ws['dropped_ops']} ops")

    if on:
        # predict: ticks ran, every registered check has a score in [0, 1]
        st = d.predictor.status()
        scores = d.predictor.scores()["components"]
        if st["ticks"] < 1 or set(scores) != set(d.registry.names()) or not all(
                0.0 <= v["score"] <= 1.0 for v in scores.values()):
            raise AssertionError(f"predict: {st}, scores {scores}")
        tick_ms = predict_engine._h_tick.get_sum() / predict_engine._h_tick.get_count() * 1e3
        rec["predict"] = {"ticks": st["ticks"], "armed": st["armed"],
                          "warnings": st["warnings_total"], "warns": dict(warns),
                          "calibrated": d.predictor.calibration()["classes"],
                          "scores": {k: v["score"] for k, v in scores.items()},
                          "tick_host_ms": tick_ms}
        # fabric: the card's NVLink ports from NVML, every one up, none published
        fs = d.fabric.status()
        ports = len(d.gpu_instance.nvlink_links())
        states = {r["link"]: r["state"] for r in d.fabric.matrix()}
        if fs["mesh"]["source"] != "nvml" or fs["links"] != ports or ports < 1 or \
                set(states.values()) != {"up"} or fs["published"]:
            raise AssertionError(f"fabric: {fs}, {ports} ports, states {states}")
        sweep_ms = fabric_plane._h_sweep.get_sum() / fabric_plane._h_sweep.get_count() * 1e3
        rec["fabric"] = {"mesh": fs["mesh"], "links": fs["links"], "published": fs["published"],
                         "sweep_host_ms": sweep_ms}
        rec["plane_job_host_ms"] = {k: [pct(v, 0.5), max(v, default=0.0), len(v)]
                                    for k, v in job_ms.items()}
        say(f"predict: {st['ticks']} ticks, {len(scores)} checks scored in [0, 1], armed "
            f"{st['armed']}, warnings {dict(warns)}; {tick_ms:.3f} host ms per tick. fabric: "
            f"{fs['mesh']} from NVML, {fs['links']} links all up, 0 published; "
            f"{sweep_ms:.3f} host ms per sweep; [p50, max, runs] host ms of the calibrate and "
            f"replay jobs {rec['plane_job_host_ms']}")

    err = d.registry.get(err_kmsg)
    rec["native"] = {"available": _native.available(), "backend": _native.backend(),
                     "path": _native.loaded_path(),
                     "deduper": type(err.syncer.deduper).backend,
                     "nvlink_store": d.registry.get("accelerator-gpu-nvlink").store.backend}
    say(f"native: {rec['native']}")

    # shutdown: flush, checkpoint, close
    d.storage_writer.flush()
    rec["checkpoint"] = checkpoint_wal(d.db_rw, d.storage_writer)
    d.stop()
    if on:
        rec.update(planes_after_stop(d, w, produced, warns, events_unjournaled))
    rec["refused_executor_calls"] = calls
    rec["torch_loaded"] = sorted(m for m in _sys.modules if m.split(".")[0] == "torch")
    rec["kmsg_latency_ms"] = marks
    return rec


def child_code(*fns, call: str) -> str:
    """A ``python -c`` program of these functions' sources that prints
    ``call``'s result as its last line, after ``no_public_network``."""
    return "\n".join([
        "import json, sys",
        "from gpud_tpu_torch import netutil",
        "from gpud_tpu_torch.providers import detect as provider_detect",
        inspect.getsource(no_public_network),
        "no_public_network()",
        f"PROBE_FILE_MB = {PROBE_FILE_MB}",
        *(inspect.getsource(fn) for fn in fns),
        f"print(json.dumps({call}), flush=True)",
    ])


def run_daemon_child(w: Path, planes: str, lib: Path) -> dict:
    """``daemon_child`` in a child without torch; its lines are printed
    here and its record is gated: no torch, no executor call, the native
    library in use, the dirtied pages within the budget."""
    code = child_code(mapped_file_probe, daemon_child,
                      call="{'daemon_child': daemon_child(sys.argv[1], sys.argv[2])}")
    env = dict(os.environ, TPUD_KMSG_FILE_PATH=str(w / "kmsg"), TPUD_NATIVE_LIB=str(lib))
    proc = subprocess.run([sys.executable, "-c", code, str(w), planes], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    out = proc.stdout.splitlines()
    for row in out[:-1] if proc.returncode == 0 else out:
        print(row, flush=True)
    if proc.returncode != 0 or not out:
        sys.stderr.write(proc.stderr[-8000:])
        raise AssertionError(f"the daemon child (planes {planes}) exited {proc.returncode}")
    child = json.loads(out[-1])["daemon_child"]
    if child["torch_loaded"]:
        raise AssertionError(f"the daemon child loaded {child['torch_loaded']}")
    if child["refused_executor_calls"]:
        raise AssertionError(f"executors called: {child['refused_executor_calls']}")
    if child["steady"]["dirty_mb"] > DAEMON_RSS_BUDGET_MB:
        raise AssertionError(f"daemon memory {child['steady']} over the {DAEMON_RSS_BUDGET_MB} MB "
                             f"budget")
    if not (child["native"]["available"] and child["native"]["path"] == str(lib)
            and child["native"]["deduper"] == "native"
            and child["native"]["nvlink_store"] == "native"):
        raise AssertionError(f"the daemon child ran without the native library: {child['native']}")
    return child


def construct_child(workdir: str, planes: str) -> dict:
    """VmRSS and dirtied pages after the daemon's imports and after
    ``Daemon()``, with the predict, fabric and outbox planes on or off; run
    in a child without torch."""
    from pathlib import Path as _Path

    def mb():
        status = dict(row.split(":", 1) for row in
                      _Path("/proc/self/status").read_text().splitlines() if ":" in row)
        dirty = sum(int(row.split()[1]) for row in _Path("/proc/self/smaps").read_text().splitlines()
                    if row.startswith(("Private_Dirty:", "Shared_Dirty:")))
        return [int(status["VmRSS"].split()[0]) / 1024.0, dirty / 1024.0]

    import importlib

    out = {"interpreter": mb()}
    # the core's modules, then the planes' (msgpack among them where it is
    # installed), then the daemon module itself
    for mod in ("gpud_tpu_torch.config", "gpud_tpu_torch.components.all",
                "gpud_tpu_torch.health_history", "gpud_tpu_torch.remediation.engine",
                "gpud_tpu_torch.scheduler", "gpud_tpu_torch.storage", "gpud_tpu_torch.metrics.store",
                "gpud_tpu_torch.kmsg.syncer", "gpud_tpu_torch.gpu.instance"):
        importlib.import_module(mod)
    out["core_imports"] = mb()
    for mod in ("gpud_tpu_torch.predict", "gpud_tpu_torch.fabric", "gpud_tpu_torch.session.outbox"):
        importlib.import_module(mod)
    out["plane_imports"] = mb()
    from gpud_tpu_torch.config import default_config
    from gpud_tpu_torch.daemon import Daemon

    out["imports"] = mb()
    off = {} if planes == "on" else dict(predict_enabled=False, fabric_sweep_enabled=False,
                                         outbox_enabled=False)
    d = Daemon(default_config(data_dir=workdir, kmsg_path=workdir + "/kmsg", **off))
    out["construct"] = mb()
    d.stop()
    return out


def plane_cost(workdir: Path) -> dict:
    """[VmRSS, dirtied] MB after the imports and after ``Daemon()`` in a
    child without torch, with the planes off and on, and the difference.
    Runs on any host; on one without NVML set TPUD_GPU_MOCK_ALL_SUCCESS=1."""
    got = {}
    for planes in ("off", "on"):
        w = workdir / f"construct_{planes}"
        w.mkdir()
        (w / "kmsg").touch()
        proc = subprocess.run([sys.executable, "-c", child_code(
            construct_child, call="construct_child(sys.argv[1], sys.argv[2])"), str(w), planes],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            raise AssertionError(f"the construction child (planes {planes}) exited "
                                 f"{proc.returncode}")
        got[planes] = json.loads(proc.stdout.splitlines()[-1])
    got["construct_on_minus_off"] = [round(a - b, 3) for a, b in
                                     zip(got["on"]["construct"], got["off"]["construct"])]
    got["plane_imports_minus_core"] = [round(a - b, 3) for a, b in
                                       zip(got["on"]["plane_imports"], got["on"]["core_imports"])]
    return got


def native_parity(store_db: Path, workdir: Path, smi_line: str) -> dict:
    """The native library against its Python twins on this machine: the kmsg
    parser on the corpus, the deduper in lockstep, the catalog prefilter
    against its regex, the ragged scan against the Python walk on the
    daemon's NVLink rows; then µs per line and ms per scan of each path, the
    scan at one host's day (144 links x 1440 samples)."""
    corpus = load_corpus()
    lines = [ln for ls in corpus.ORGANIC.values() for ln in ls] + list(corpus.BENIGN)
    records = [f"3,{1000 + i},{5_000_000 + 17 * i},-;{ln}" for i, ln in enumerate(lines)]
    saved = (kmsg_watcher._native_parse, catalog._NATIVE_PREFILTER)
    rec = {"lines": len(lines)}
    try:
        def parse_all(parser):
            kmsg_watcher._native_parse = parser
            return [dataclasses.astuple(kmsg_watcher.parse_line(r, 1.7e9)) for r in records]

        py, nat = parse_all(None), parse_all(native.parse_kmsg)
        if py != nat:
            raise AssertionError("native kmsg parser differs from the Python one")
        for name, parser in (("python", None), ("native", native.parse_kmsg)):
            kmsg_watcher._native_parse = parser
            rec[f"parse_us_per_line_{name}"] = host_ms(
                lambda: [kmsg_watcher.parse_line(r, 1.7e9) for r in records]) * 1e3 / len(records)

        rng = np.random.default_rng(SEED)
        clock = [0.0]
        dn = kmsg_deduper.NativeBackedDeduper(60.0, 64, time_now_fn=lambda: clock[0])
        dp = kmsg_deduper.Deduper(60.0, 64, time_now_fn=lambda: clock[0])
        for step in range(5000):
            clock[0] += float(rng.exponential(0.2))
            key, ts = lines[int(rng.integers(0, len(lines)))], float(rng.integers(0, 4))
            if dn.seen_before(key, ts) != dp.seen_before(key, ts) or len(dn) != len(dp):
                raise AssertionError(f"native deduper differs from the Python one at step {step}")
        rec["deduper_lockstep_steps"] = 5000

        if not native.prefilter_init(catalog.PREFILTER_TOKENS):
            raise AssertionError("the native prefilter did not arm")
        regex = [catalog._PREFILTER.search(ln) is not None for ln in lines]
        if [native.prefilter_match(ln) for ln in lines] != regex:
            raise AssertionError("native prefilter differs from the regex")
        for name, armed in (("python", False), ("native", True)):
            catalog._NATIVE_PREFILTER = armed
            rec[f"match_us_per_line_{name}"] = host_ms(
                lambda: [catalog.match(ln) for ln in lines]) * 1e3 / len(lines)

        def both_scans(db_path, window, now):
            db = DB(str(db_path))
            store = NVLinkStore(db)
            store.time_now_fn = lambda: now
            out = {}
            for name, enabled in (("python", False), ("native", True)):
                store.native_enabled = enabled
                out[name] = store.scan(window)
                if store.backend != name:
                    raise AssertionError(f"scan ran {store.backend}, not {name}")
                out[f"{name}_ms"] = host_ms(lambda: store.scan(window), reps=3)
            db.close()
            if out["python"] != out["native"]:
                raise AssertionError(f"native ragged scan differs from the Python walk on {db_path}")
            return out

        now = time.time()
        daemon_scan = both_scans(store_db, 3600.0, now)
        rec["daemon_store_links"] = len(daemon_scan["native"].links)
        day_db = workdir / "native_day.db"
        h = max(seeded_faults(NATIVE_T), key=lambda k: len(seeded_faults(NATIVE_T)[k]))
        write_host_db(day_db, h, now, NATIVE_T)
        day = both_scans(day_db, WINDOW_SECONDS, now)
        rec["day_links"], rec["day_samples"] = len(day["native"].links), NATIVE_T
        rec["scan_ms_python"], rec["scan_ms_native"] = day["python_ms"], day["native_ms"]
    finally:
        kmsg_watcher._native_parse, catalog._NATIVE_PREFILTER = saved
    line("daemon", f"native parity: {len(lines)} corpus lines parsed equal (native, Python), "
                   f"deduper lockstep over 5000 steps, prefilter equal to the regex on every "
                   f"line, ragged scan equal on the daemon's {rec['daemon_store_links']} links and "
                   f"on {rec['day_links']} x {NATIVE_T}")
    line("daemon", f"native vs Python: parse {rec['parse_us_per_line_native']:.3f} / "
                   f"{rec['parse_us_per_line_python']:.3f} us per line, catalog match "
                   f"{rec['match_us_per_line_native']:.3f} / {rec['match_us_per_line_python']:.3f} "
                   f"us per line, scan {rec['scan_ms_native']:.3f} / {rec['scan_ms_python']:.3f} ms "
                   f"at {rec['day_links']} x {NATIVE_T} (host clock) [{smi_line}]")
    return rec


# nvmlDeviceGetFieldValues with the NVLink error fields of GPU 0's links,
# its array placed so that it ends ``spare`` bytes before a page the process
# may not touch: whether NVML stays inside the array (gpu/nvml.py
# FIELD_VALUES_SPARE)
FIELD_VALUES_GUARD = r"""
import ctypes, mmap, sys
from gpud_tpu_torch.gpu import nvml as N
spare = int(sys.argv[1])
nv = N.NVML()
assert nv.init() == ""
h = nv.handle(0)
reqs = [(fid, link) for link in range(N.NVML_NVLINK_MAX_LINKS) for _c, fid in N.LINK_COUNTER_FIELDS]
size = len(reqs) * ctypes.sizeof(N.FieldValue)
pages = (size + spare) // mmap.PAGESIZE + 2
m = mmap.mmap(-1, pages * mmap.PAGESIZE)
base = ctypes.addressof(ctypes.c_char.from_buffer(m))
guard = base + (pages - 1) * mmap.PAGESIZE
libc = ctypes.CDLL(None)
libc.mprotect.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
assert libc.mprotect(guard, mmap.PAGESIZE, 0) == 0
arr = (N.FieldValue * len(reqs)).from_address(guard - spare - size)
for _ in range(20):
    for fv, (fid, link) in zip(arr, reqs):
        fv.fieldId, fv.scopeId = fid, link
    nv._call("nvmlDeviceGetFieldValues", h, len(reqs), arr)
print(len(reqs), "fields, statuses", sorted({fv.nvmlReturn for fv in arr}), flush=True)
"""


def field_values_guard(spare_entries=(nvml_mod.FIELD_VALUES_SPARE,)) -> dict:
    """The field-values call in a child, its array right before a guard page
    with each count of spare entries: the binding's (the default, the smoke's
    gate) must leave the child alive. Called by hand with ``(0, 1)`` it shows
    the overrun itself: with no spare entry NVML 580 on the H100 touches the
    guard page and the child dies of SIGSEGV (exit -11)."""
    out = {}
    for entries in spare_entries:
        spare = entries * ctypes.sizeof(nvml_mod.FieldValue)
        r = subprocess.run([sys.executable, "-c", FIELD_VALUES_GUARD, str(spare)], cwd=ROOT,
                           capture_output=True, text=True, timeout=120)
        out[spare] = {"rc": r.returncode, "out": r.stdout.strip()}
        line("daemon", f"nvmlDeviceGetFieldValues, NVLink error fields, array {spare} bytes "
                       f"before a guard page: exit {r.returncode}, {r.stdout.strip()}")
    binding = nvml_mod.FIELD_VALUES_SPARE * ctypes.sizeof(nvml_mod.FieldValue)
    if binding in out and out[binding]["rc"] != 0:
        raise AssertionError(f"nvmlDeviceGetFieldValues faults with the binding's {binding} "
                             f"spare bytes: {out}")
    return {str(k): v["rc"] for k, v in out.items()}


def phase_daemon(workdir: Path, smi_line: str) -> dict:
    """The daemon on the card's machine: the native library built, the
    planes' construction cost (``plane_cost``), the daemon run in a child
    without torch (``daemon_child``) with the planes off and then on, then
    the second run's state DB read again here: integrity, a restart that
    adds no transition and keeps the outbox's watermarks, the CLI,
    ``fleet_scan`` on the card over the NVLink history the daemon wrote,
    and the native library against its Python twins."""
    t_phase = time.perf_counter()
    for env in (gpu_instance.ENV_MOCK_ALL_SUCCESS, gpu_instance.ENV_USE_TORCH):
        os.environ.pop(env, None)
    # built into the phase's own directory and named to this process and the
    # child, so the checkout's build/native/ stays empty and later processes
    # there keep the Python twins
    t0 = time.perf_counter()
    lib = native.build(workdir / "native")
    build_s = time.perf_counter() - t0
    os.environ["TPUD_NATIVE_LIB"] = str(lib)
    try:
        loaded = native.available() and native.loaded_path() == str(lib)
    finally:
        del os.environ["TPUD_NATIVE_LIB"]
    if not loaded:
        raise AssertionError(f"the native library built at {lib} does not load")
    line("daemon", f"native.build(): {lib} in {build_s:.3f} s")
    costs = plane_cost(workdir)
    # the core alone first (the memory baseline), then with the planes on;
    # the second run's state DB is the one read below
    children, child_s = {}, {}
    for planes in ("off", "on"):
        w = workdir / ("daemon" if planes == "on" else "daemon_planes_off")
        w.mkdir()
        (w / "kmsg").touch()
        t0 = time.perf_counter()
        children[planes] = run_daemon_child(w, planes, lib)
        child_s[planes] = time.perf_counter() - t0
    child, off = children["on"], children["off"]
    off_peak = off["steady"]["vmrss_peak_sampled_mb"]
    on_peak = child["steady"]["vmrss_peak_sampled_mb"]
    if off_peak > DAEMON_VMRSS_CEILING_MB:
        raise AssertionError(f"daemon VmRSS with the planes off {off['steady']} over its "
                             f"{DAEMON_VMRSS_CEILING_MB} MB ceiling")
    if on_peak > off_peak + PLANES_VMRSS_MB:
        raise AssertionError(f"daemon VmRSS with the planes on {on_peak:.1f} MB, more than "
                             f"{PLANES_VMRSS_MB} MB over the planes off ({off_peak:.1f} MB)")
    line("daemon", f"VmRSS sampled peak: planes off {off_peak:.1f} MB (ceiling "
                   f"{DAEMON_VMRSS_CEILING_MB}), on {on_peak:.1f} MB (+{on_peak - off_peak:.1f}, "
                   f"ceiling +{PLANES_VMRSS_MB}); dirtied {off['steady']['dirty_mb']:.1f} / "
                   f"{child['steady']['dirty_mb']:.1f} MB (budget {DAEMON_RSS_BUDGET_MB}); "
                   f"CPU s per s {off['steady']['cpu_s_per_s']:.5f} / "
                   f"{child['steady']['cpu_s_per_s']:.5f}; construction alone {costs}")
    w = workdir / "daemon"

    state = w / "tpud.state"
    conn = sqlite3.connect(state)
    try:
        integrity = conn.execute("PRAGMA integrity_check").fetchone()[0]
    finally:
        conn.close()
    if integrity != "ok":
        raise AssertionError(f"integrity_check: {integrity}")
    # the restart: a fresh ledger and one check of the error component
    db = DB(str(state))
    es = EventStore(db)
    ledger = HealthLedger(db)
    before = len(ledger.history())
    comp = GPUErrorKmsgComponent(TpudInstance(
        gpu_instance=gpu_instance.new_instance(), event_store=es,
        reboot_event_store=host_mod.RebootEventStore(es), health_ledger=ledger))
    cr = comp.check()
    after = len(ledger.history())
    outbox = SessionOutbox(db)
    watermarks = (outbox.last_seq, outbox.acked_seq)
    db.close()
    if after != before or cr.health_state_type() != HealthStateType.HEALTHY:
        raise AssertionError(f"restart: {before} -> {after} transitions, {cr.health_state_type()}")
    n = child["outbox"]["records"]
    if watermarks != (n, n):
        raise AssertionError(f"restart: the outbox's (last_seq, acked_seq) {watermarks}, not {n}")
    fabric_rows = child["fabric_rows"]
    cli = {}
    for sub in ("history", "remediation"):
        r = subprocess.run([sys.executable, "-m", "gpud_tpu_torch", sub, "--json",
                            "--component", ERR_KMSG, "--data-dir", str(w)],
                           cwd=ROOT, capture_output=True, text=True, timeout=120, check=True)
        cli[sub] = json.loads(r.stdout)
    attempts = [(a["action"], a["decision"], a["outcome"]) for a in cli["remediation"]["attempts"]]
    reactive = [a for a in attempts if a[0] != "predicted_warning"]
    predicted = [a for a in attempts if a[0] == "predicted_warning"]
    if [(t["from"], t["to"]) for t in cli["history"]["transitions"]] != [
            ("Unhealthy", "Healthy"), ("Healthy", "Unhealthy")] or \
            reactive != [("reboot_system", "dry_run", "dry_run")] or \
            len(predicted) != child["predict"]["warns"].get(ERR_KMSG, 0) or \
            any(a[1:] != ("dry_run", "dry_run") for a in predicted):
        raise AssertionError(f"CLI on the daemon's state DB: {cli}")

    # fleet_scan on the card over the NVLink history this daemon wrote
    now = time.time()
    sdb = DB(str(state))
    store = NVLinkStore(sdb)
    store.time_now_fn = lambda: now
    ref = store.scan(3600.0)
    sdb.close()
    res, launches, names = fleet_scan_of_store(state, ref, 3600.0, now)
    line("daemon", f"restart: a fresh HealthLedger and one check, {before} -> {after} "
                   f"transitions; the outbox's last_seq and acked_seq {watermarks}; "
                   f"{fabric_rows} fabric rows; integrity_check {integrity}; CLI history and remediation "
                   f"--json show 2 transitions and the dry-run row; fleet_scan over the daemon's "
                   f"{len(names)} links of {max(s.samples for s in ref.links.values())} samples: "
                   f"{launches} launch, {res['summary']}, equal to NVLinkStore.scan and "
                   f"device='cpu'")
    parity = native_parity(state, workdir, smi_line)
    guard = field_values_guard()

    rec = {"card": smi_line, **child, "native_build_s": build_s, "child_wall_s": child_s,
           "planes_off": {k: off[k] for k in ("steady", "vmrss_mb_at", "scheduler", "writer",
                                                "kmsg_latency_ms", "jobs")},
           "planes_vmrss_increment_mb": on_peak - off_peak, "construction_vmrss_mb": costs,
           "outbox_after_restart": watermarks,
           "integrity_check": integrity, "restart_new_transitions": after - before,
           "cli_history_transitions": len(cli["history"]["transitions"]),
           "cli_remediation_rows": len(cli["remediation"]["attempts"]),
           "fleet_scan": {"links": len(names), "launches": launches, "summary": res["summary"]},
           "packed_scan_launches": launches, "native_parity": parity,
           "field_values_guard_rc_by_spare_bytes": guard,
           "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"daemon": rec}), flush=True)
    return rec


# -- 8. analytics ---------------------------------------------------------------

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


# -- 9. timings ---------------------------------------------------------------------

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
        adapter = phase_adapter(workdir, smi)
        phase_health(workdir, smi)
        phase_host(workdir, smi, adapter["c1"])
        daemon = phase_daemon(workdir, smi)
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
        "launches_by_path": {"fleet": fleet["launches"], "adapter": adapter["launches"],
                             "daemon": daemon["packed_scan_launches"]},
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
