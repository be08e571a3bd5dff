"""Whether the sweeps of a run gave the reference's answer.

Each number is compared with its limit. All are exact comparisons, so
every limit is 0: a link in a wrong class, a summary or a truncation list
that differs, a sweep on another number of devices than the host's cards,
or a sweep that raised.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

LIMITS = {
    "wrong_links": 0,      # most links whose class differs in one sweep
    "wrong_summary": 0,    # sweeps whose summary differs
    "wrong_truncated": 0,  # sweeps whose truncated_links differ
    "wrong_devices": 0,    # sweeps that ran on another number of devices
    "raised": 0,           # sweeps that raised
}


def wrong_links(result: dict, ref: dict) -> int:
    """Links of the reference missing from ``result`` or in another class,
    plus links ``result`` has and the reference has not."""
    got, want = result.get("links", {}), ref["links"]
    return (sum(1 for k, v in want.items() if got.get(k) != v)
            + sum(1 for k in got if k not in want))


def judge(results: List[Tuple[dict, int]], raised: int, ref: dict,
          expect_devices: int) -> Tuple[Dict[str, dict], int]:
    """``results`` holds each distinct answer with the number of sweeps that
    gave it. Returns the checks (number and limit by name) and how many
    sweeps failed: raised, or answered other than the reference."""
    n = dict.fromkeys(LIMITS, 0)
    n["raised"] = raised
    failed = raised
    for res, count in results:
        links = wrong_links(res, ref)
        summary = res.get("summary") != ref["summary"]
        trunc = sorted(res.get("truncated_links", [])) != ref["truncated_links"]
        devices = res.get("devices") != expect_devices
        n["wrong_links"] = max(n["wrong_links"], links)
        n["wrong_summary"] += count * summary
        n["wrong_truncated"] += count * trunc
        n["wrong_devices"] += count * devices
        failed += count * bool(links or summary or trunc or devices)
    return {k: {"value": n[k], "limit": LIMITS[k]} for k in LIMITS}, failed


def passed(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
