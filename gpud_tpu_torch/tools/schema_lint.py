"""Schema lint: the wire and journal formats are frozen in a golden.

Every byte format two processes (or two *builds*, across a rolling
fleet upgrade) must agree on is pinned in
``gpud_tpu_torch/tools/goldens/wire_schema.json``:

- the rev-3 codec prefixes and :func:`wire.decode_payload` behavior,
  proved against frozen hex wire samples (a ``j``/``z``/``m``/``M``
  payload captured when the format shipped must decode to the same
  object forever);
- :class:`wire.DeltaEncoder` output for a fixed record sequence — the
  len-6 keyframe and len-7 delta positional arrays, the
  ``kind:component`` stream keys, the non-dict payload case — plus the
  decoder round-trip;
- the ``outbox_batch`` frame shape (``BATCH_KEY``/``BATCH_VERSION``/
  ``first_seq``/``last_seq``/``count``/``records``);
- the v2 Frame revisions: ``MAX_REVISION``, the rev-2 bare-JSON
  ``Result.payload_json`` bytes, the rev-3 prefix-framed round-trip,
  and the :func:`typed.negotiate_revision` table;
- the journal / session-outbox / fleet-replica SQLite row schemas
  (table name + ordered column list, parsed from the ``CREATE TABLE``
  source so no database is touched);
- the versioned predict payloads: ``PREDICT_SCHEMA`` /
  ``PREDICT_SCHEMA_MAX`` and the key sets of every payload dict in
  ``predict/engine.py`` that stamps ``"schema": PREDICT_SCHEMA``.

Any drift — a renamed column, a reordered record field, a new key in a
versioned payload, a changed negotiation result — fails lint until the
golden is regenerated with ``python -m gpud_tpu_torch.tools.lint_all
--update-goldens``, which bumps ``golden_version``. The bump is the
point: it forces the diff (and the compatibility story for agents one
build behind) into review instead of letting the format drift under a
green suite whose encoder and decoder drifted together.

msgpack-framed probes are checked only when msgpack is importable (the
container bakes it in; slim installs degrade to JSON framing) — the
golden carries them unconditionally so a full build always checks the
full surface.

Run: ``python -m gpud_tpu_torch.tools.schema_lint``; registered in
``tools/lint_all.py`` so tier-1 enforces it.
"""

from __future__ import annotations

import ast
import json
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

from gpud_tpu_torch.tools.guard_lint import _repo_root

GOLDEN_REL = "gpud_tpu_torch/tools/goldens/wire_schema.json"

# -- frozen probe inputs -----------------------------------------------------
# These hex strings are *inputs* captured when the format shipped; they
# are never regenerated. decode_payload must understand them forever
# (zlib.decompress and msgpack decoding are stable; only our framing
# could break them).
DECODE_PROBES: Dict[str, str] = {
    "json": "6a7b2261223a312c2262223a5b312c322c335d2c22636f6d706f6e656e74223a"
            "2274707530227d",
    "zlib_json": "7a7801ab564acecf2dc8cf4bcd2b51b2522a29283550d2512a49ad00f1"
                 "1293925346320686449e9295792d00927c6d99",
    "msgpack": "6d83a16101a16293010203a9636f6d706f6e656e74a474707530",
    "zlib_msgpack": "4d78016b5e999c9f5b909f979a57b2a4a4a0d46049496a45c92d46"
                    "86c4a4e494918c17e6b10300b89a6e07",
}
_MSGPACK_ONLY = ("msgpack", "zlib_msgpack")

# fixed record sequence for the delta codec: with keyframe_interval=3
# it exercises keyframe, field-change delta, key-removal delta, the
# interval rollover back to a keyframe, a second interleaved stream,
# and the non-dict payload shape
DELTA_INPUT: List[Tuple[int, float, str, str, object]] = [
    (1, 10.5, "health", "h:tpu0:1", {"component": "tpu0", "health": "ok",
                                     "reason": "boot"}),
    (2, 11.5, "health", "h:tpu0:2", {"component": "tpu0", "health": "bad",
                                     "reason": "boot"}),
    (3, 12.5, "health", "h:tpu0:3", {"component": "tpu0", "health": "bad"}),
    (4, 13.5, "metric", "m:tpu1:1", {"component": "tpu1", "v": 1}),
    (5, 14.5, "health", "h:tpu0:4", {"component": "tpu0", "health": "ok"}),
    (6, 15.5, "event", "e:1", "raw-string-payload"),
]
DELTA_KEYFRAME_INTERVAL = 3

NEGOTIATE_ACKS = (0, 1, 2, 3, 4, 9)

# (view key, repo-relative module, table-name constant in that module)
TABLES = (
    ("journal", "gpud_tpu_torch/manager/rollup.py", "TABLE"),
    ("outbox", "gpud_tpu_torch/session/outbox.py", "TABLE"),
    ("replica", "gpud_tpu_torch/manager/federation.py", "REPLICA_TABLE"),
)

_CONSTRAINT_WORDS = frozenset({
    "UNIQUE", "PRIMARY", "FOREIGN", "CHECK", "CONSTRAINT",
})


# -- source extraction (no imports of heavy modules) -------------------------

def _read(root: str, rel: str) -> str:
    with open(os.path.join(root, rel), encoding="utf-8") as f:
        return f.read()


def _table_schema(text: str, const: str,
                  rel: str) -> Tuple[Optional[str], List[str], List[str]]:
    """(table name, ordered columns, problems) parsed from source."""
    problems: List[str] = []
    m = re.search(rf'^{const}\s*=\s*"([^"]+)"', text, re.M)
    if m is None:
        return None, [], [f"{rel}: no `{const} = \"...\"` constant found"]
    name = m.group(1)
    marker = f"CREATE TABLE IF NOT EXISTS {{{const}}}"
    idx = text.find(marker)
    if idx < 0:
        return name, [], [f"{rel}: no CREATE TABLE statement for {const}"]
    open_idx = text.find("(", idx)
    depth, end = 0, -1
    for i in range(open_idx, len(text)):
        if text[i] == "(":
            depth += 1
        elif text[i] == ")":
            depth -= 1
            if depth == 0:
                end = i
                break
    if end < 0:
        return name, [], [f"{rel}: unbalanced CREATE TABLE for {const}"]
    cols: List[str] = []
    for line in text[open_idx + 1:end].splitlines():
        tok = line.strip().split(" ", 1)[0].rstrip(",")
        if tok and tok.upper() not in _CONSTRAINT_WORDS and tok.isidentifier():
            cols.append(tok)
    return name, cols, problems


def _module_int(text: str, const: str, rel: str,
                problems: List[str]) -> Optional[int]:
    m = re.search(rf"^{const}\s*=\s*(\d+)", text, re.M)
    if m is None:
        problems.append(f"{rel}: no `{const} = <int>` constant found")
        return None
    return int(m.group(1))


def _predict_key_sets(text: str, rel: str,
                      problems: List[str]) -> List[List[str]]:
    """Sorted key lists of every dict literal stamping
    ``"schema": PREDICT_SCHEMA`` in predict/engine.py — the versioned
    payload surface."""
    try:
        tree = ast.parse(text, filename=rel)
    except SyntaxError as e:
        problems.append(f"{rel}: unparseable: {e}")
        return []
    out: List[List[str]] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Dict):
            continue
        stamped = False
        for k, v in zip(node.keys, node.values):
            if (isinstance(k, ast.Constant) and k.value == "schema"
                    and isinstance(v, ast.Name)
                    and v.id == "PREDICT_SCHEMA"):
                stamped = True
        if not stamped:
            continue
        keys = sorted(
            k.value for k in node.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)
        )
        out.append(keys)
    if not out:
        problems.append(
            f"{rel}: no payload dict stamps \"schema\": PREDICT_SCHEMA — "
            "the versioned predict surface is gone"
        )
    return sorted(out)


# -- the current view --------------------------------------------------------

def current_view(root: str) -> Tuple[Dict, List[str]]:
    """(diffable schema view computed from the current tree, problems).

    Everything in the view is JSON-canonical; behavioral checks are
    folded in as booleans so a behavior regression shows up as a diff
    against the golden's ``true``.
    """
    problems: List[str] = []
    from gpud_tpu_torch.session import wire

    view: Dict = {}
    view["prefixes"] = {
        "json": wire.PREFIX_JSON.decode("ascii"),
        "zlib": wire.PREFIX_ZLIB.decode("ascii"),
        "msgpack": wire.PREFIX_MSGPACK.decode("ascii"),
        "zlib_msgpack": wire.PREFIX_ZLIB_MSGPACK.decode("ascii"),
    }

    # frozen wire samples → whatever the current decoder says they mean
    probes: Dict[str, object] = {}
    for name, hexstr in DECODE_PROBES.items():
        if name in _MSGPACK_ONLY and wire._msgpack is None:
            continue  # slim install: golden-only paths are skipped too
        try:
            probes[name] = wire.decode_payload(bytes.fromhex(hexstr))
        except Exception as e:  # noqa: BLE001 - any failure IS the finding
            probes[name] = f"DECODE FAILED: {e}"
    view["decode_probes"] = probes

    # encode → decode must round-trip regardless of codec availability
    rt_obj = {"component": "tpu0", "n": [1, 2, 3], "s": "x" * 600}
    try:
        small = wire.encode_payload({"a": 1}, min_bytes=1 << 30)
        big = wire.encode_payload(rt_obj, min_bytes=0)
        view["encode_round_trip"] = (
            wire.decode_payload(small) == {"a": 1}
            and wire.decode_payload(big) == rt_obj
            and small[:1] in (wire.PREFIX_JSON, wire.PREFIX_MSGPACK)
            and big[:1] in (wire.PREFIX_ZLIB, wire.PREFIX_ZLIB_MSGPACK)
        )
    except Exception as e:  # noqa: BLE001
        view["encode_round_trip"] = f"FAILED: {e}"

    # delta codec over the fixed sequence
    enc = wire.DeltaEncoder(keyframe_interval=DELTA_KEYFRAME_INTERVAL)
    encoded = [
        enc.encode_record(seq, ts, kind, key,
                          dict(p) if isinstance(p, dict) else p)
        for seq, ts, kind, key, p in DELTA_INPUT
    ]
    view["delta"] = {
        "keyframe_interval": DELTA_KEYFRAME_INTERVAL,
        "encoded": encoded,
        "record_lengths": [len(r) for r in encoded],
    }
    dec = wire.DeltaDecoder()
    try:
        decoded = [dec.decode_record(r) for r in encoded]
        view["delta"]["round_trip"] = all(
            (seq, ts, kind, key) == tuple(d[:4]) and p == d[4]
            for (seq, ts, kind, key, p), d in zip(DELTA_INPUT, decoded)
        )
    except wire.DeltaDecodeError as e:
        view["delta"]["round_trip"] = f"FAILED: {e}"

    view["batch"] = {
        "batch_key": wire.BATCH_KEY,
        "batch_version": wire.BATCH_VERSION,
        "frame": wire.build_batch(encoded),
        "parse_inverse": wire.parse_batch(wire.build_batch(encoded))
        == wire.build_batch(encoded)[wire.BATCH_KEY],
    }

    # v2 Frame revisions
    cp_text = _read(root, "gpud_tpu_torch/manager/control_plane.py")
    max_rev = _module_int(cp_text, "MAX_REVISION",
                          "gpud_tpu_torch/manager/control_plane.py", problems)
    rev: Dict = {"max_revision": max_rev}
    try:
        from gpud_tpu_torch.session.v2 import typed

        rev["negotiate"] = {
            str(ack): typed.negotiate_revision(ack, max_rev or 0)
            for ack in NEGOTIATE_ACKS
        }
        pkt = typed.make_result("r1", {"a": 1}, compress=False)
        rev["rev2_payload_hex"] = pkt.result.payload_json.hex()
        pkt3 = typed.make_result("r1", rt_obj, compress=True)
        rev["rev3_round_trip"] = (
            wire.decode_payload(pkt3.result.payload_json) == rt_obj
        )
    except ImportError as e:  # pragma: no cover - protobuf always baked in
        problems.append(
            f"gpud_tpu_torch/session/v2/typed.py: cannot import to probe Frame "
            f"revisions: {e}"
        )
    view["frame_revisions"] = rev

    # row schemas, parsed from source
    tables: Dict = {}
    for key, rel, const in TABLES:
        name, cols, p = _table_schema(_read(root, rel), const, rel)
        problems.extend(p)
        tables[key] = {"name": name, "columns": cols}
    view["tables"] = tables

    # versioned predict payloads
    cal_rel = "gpud_tpu_torch/predict/calibrate.py"
    roll_rel = "gpud_tpu_torch/manager/rollup.py"
    eng_rel = "gpud_tpu_torch/predict/engine.py"
    view["predict"] = {
        "schema": _module_int(_read(root, cal_rel), "PREDICT_SCHEMA",
                              cal_rel, problems),
        "schema_max": _module_int(_read(root, roll_rel), "PREDICT_SCHEMA_MAX",
                                  roll_rel, problems),
        "payload_key_sets": _predict_key_sets(_read(root, eng_rel), eng_rel,
                                              problems),
    }
    # canonicalize (tuples → lists, key order) so diffs are type-stable
    return json.loads(json.dumps(view, sort_keys=True)), problems


# -- diff --------------------------------------------------------------------

def _flatten(obj, prefix: str, out: Dict[str, object]) -> None:
    if isinstance(obj, dict):
        for k in sorted(obj):
            _flatten(obj[k], f"{prefix}.{k}" if prefix else str(k), out)
    elif isinstance(obj, list):
        out[f"{prefix}#len"] = len(obj)
        for i, v in enumerate(obj):
            _flatten(v, f"{prefix}[{i}]", out)
    else:
        out[prefix] = obj


def _skip_for_env(path: str) -> bool:
    """Golden paths a slim install (no msgpack) cannot check."""
    from gpud_tpu_torch.session import wire

    if wire._msgpack is not None:
        return False
    return any(path.startswith(f"decode_probes.{n}") for n in _MSGPACK_ONLY)


def run_full(root: str = "",
             golden_rel: str = GOLDEN_REL) -> Tuple[List[str], List[str]]:
    """(problems, notes); ([], _) = the wire surface matches the golden."""
    root = root or _repo_root()
    golden_path = os.path.join(root, golden_rel)
    if not os.path.isfile(golden_path):
        return ([
            f"{golden_rel}: golden missing — generate it with "
            "`python -m gpud_tpu_torch.tools.lint_all --update-goldens`"
        ], [])
    try:
        with open(golden_path, encoding="utf-8") as f:
            golden = json.load(f)
    except ValueError as e:
        return [f"{golden_rel}: golden is not valid JSON: {e}"], []
    version = golden.get("golden_version")
    if not (isinstance(version, int) and version >= 1):
        return [f"{golden_rel}: golden_version must be an int >= 1"], []

    view, problems = current_view(root)
    want: Dict[str, object] = {}
    got: Dict[str, object] = {}
    _flatten(golden.get("view", {}), "", want)
    _flatten(view, "", got)
    for path in sorted(set(want) | set(got)):
        if _skip_for_env(path):
            continue
        if path not in got:
            problems.append(
                f"{golden_rel}: schema drift at {path}: frozen as "
                f"{want[path]!r} but the current tree no longer produces it"
            )
        elif path not in want:
            problems.append(
                f"{golden_rel}: schema drift at {path}: current tree "
                f"produces {got[path]!r} which the golden does not pin"
            )
        elif want[path] != got[path]:
            problems.append(
                f"{golden_rel}: schema drift at {path}: golden pins "
                f"{want[path]!r}, current tree produces {got[path]!r}"
            )
    if problems:
        problems.append(
            f"{golden_rel}: wire-schema drift is a compatibility event: "
            "if intentional, regenerate with `python -m gpud_tpu_torch.tools."
            "lint_all --update-goldens` (bumps golden_version to "
            f"{version + 1}) and describe the rollout story in the PR"
        )
    notes = [f"golden_version {version}"]
    return problems, notes


def run_lint(root: str = "") -> List[str]:
    return run_full(root)[0]


def update_golden(root: str = "",
                  golden_rel: str = GOLDEN_REL) -> Tuple[str, bool]:
    """Regenerate the golden from the current tree. Returns (path,
    changed). Idempotent: an unchanged view does not bump the version."""
    root = root or _repo_root()
    view, problems = current_view(root)
    if problems:
        raise RuntimeError(
            "cannot freeze a broken schema surface: " + "; ".join(problems)
        )
    path = os.path.join(root, golden_rel)
    version = 1
    if os.path.isfile(path):
        try:
            with open(path, encoding="utf-8") as f:
                old = json.load(f)
            if old.get("view") == view:
                return path, False
            version = int(old.get("golden_version", 0)) + 1
        except (ValueError, TypeError):
            version = 1
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"golden_version": version, "view": view}, f,
                  indent=1, sort_keys=True)
        f.write("\n")
    return path, True


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--update-goldens" in argv:
        path, changed = update_golden()
        print(f"schema-lint: {'updated' if changed else 'unchanged'} {path}")
        return 0
    problems, notes = run_full()
    for n in notes:
        print(f"schema-lint: {n}")
    for p in problems:
        print(f"schema-lint: {p}", file=sys.stderr)
    if problems:
        print(f"schema-lint: {len(problems)} problem(s)", file=sys.stderr)
        return 1
    print("schema-lint: wire surface matches the golden")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
