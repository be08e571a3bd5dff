"""Link window scan and health classes as PyTorch tensor ops.

Counterpart of ``gpud_tpu/ops/window_scan.py``. Layout: ``states`` [L, T]
int8/bool (1=up), ``counters`` [L, T] int32, ``valid`` [L, T] bool, time
along the last axis. Ragged validity is allowed: a transition that spans
missing samples still counts, matching ``ICIStore.scan``, which compares
consecutive snapshots regardless of time gaps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class WindowScan(NamedTuple):
    """Per-link scan results over the window (all [L])."""

    drops: torch.Tensor           # up→down transitions
    flaps: torch.Tensor           # down→up recoveries
    currently_down: torch.Tensor  # last valid sample is down
    down_time_frac: torch.Tensor  # fraction of valid samples that are down
    counter_delta: torch.Tensor   # sum of positive counter steps (reset-safe)


def scan_links(
    states: torch.Tensor, counters: torch.Tensor, valid: torch.Tensor
) -> WindowScan:
    """Scan every link's window at once.

    Args:
      states:   [L, T] 1=up / 0=down.
      counters: [L, T] monotonic error counters (may reset to 0).
      valid:    [L, T] bool, sample present (ragged windows are padded).
    """
    states = states.to(torch.int8)
    valid = valid.to(torch.bool)
    T = states.shape[1]

    # forward-fill: the index of the last valid sample at or before t is a
    # running max over masked indices (-1 before the first valid sample)
    t_idx = torch.arange(T, device=states.device)
    ff_idx = torch.cummax(torch.where(valid, t_idx, -1), dim=1).values
    has_ff = ff_idx >= 0
    safe_idx = ff_idx.clamp(min=0)
    state_ff = states.gather(1, safe_idx)
    counter_ff = counters.gather(1, safe_idx)

    prev = state_ff[:, :-1]
    nxt = states[:, 1:]
    # a transition is counted at each valid sample that differs from the
    # last valid state seen before it
    v_pair = valid[:, 1:] & has_ff[:, :-1]
    drops = ((prev == 1) & (nxt == 0) & v_pair).sum(dim=1)
    flaps = ((prev == 0) & (nxt == 1) & v_pair).sum(dim=1)

    last_idx = ff_idx[:, -1:]
    last_state = states.gather(1, last_idx.clamp(min=0))[:, 0]
    currently_down = (last_idx[:, 0] >= 0) & (last_state == 0)

    down_time = ((states == 0) & valid).sum(dim=1)
    n_valid = valid.sum(dim=1).clamp(min=1)
    down_time_frac = down_time / n_valid

    diffs = counters[:, 1:].long() - counter_ff[:, :-1].long()
    counter_delta = torch.where(v_pair, diffs.clamp(min=0), 0).sum(dim=1)

    return WindowScan(
        drops=drops,
        flaps=flaps,
        currently_down=currently_down,
        down_time_frac=down_time_frac,
        counter_delta=counter_delta,
    )


def classify_links(
    scan, flap_threshold: int = 3, crc_threshold: int = 100
) -> torch.Tensor:
    """Health class per link: 0=healthy, 1=degraded (flap/CRC), 2=unhealthy
    (down or heavy flapping), mirroring the ici component's rules.

    ``scan`` is a :class:`WindowScan` or any result with the same
    ``drops``, ``flaps``, ``currently_down`` and ``counter_delta`` fields,
    such as ``ops.packed_scan.PackedScan``.
    """
    heavy = (scan.drops >= flap_threshold) | (scan.flaps >= flap_threshold)
    unhealthy = scan.currently_down | heavy
    degraded = (
        (scan.drops > 0)
        | (scan.flaps > 0)
        | (scan.counter_delta >= crc_threshold)
    )
    return torch.where(unhealthy, 2, torch.where(degraded, 1, 0)).to(torch.int32)
