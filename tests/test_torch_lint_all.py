"""The port's combined registration lint (gpud_tpu_torch/tools/lint_all.py)
is a tier-1 gate, as the reference's is (tests/test_lint_all.py, whose
cases this file mirrors on the port): a metric module, store module, HTTP
route, guarded attribute, config knob or wire format of gpud_tpu_torch that
misses its registry fails here.

The broken-fixture tests feed each lint a deliberately violating module
and assert it objects — a lint that silently passes everything is worse
than no lint. The whole suite runs once per module (``lint_run``); the
cases that need only one lint call it alone."""

import json
import os

import pytest

from gpud_tpu_torch.tools import boundary_lint, guard_lint, lint_all, parity_lint, schema_lint
from gpud_tpu_torch.tools.lint_all import main, problems_as_json, run_all

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lint_run():
    return run_all()


def test_all_lints_clean(lint_run):
    assert lint_run == []


def test_json_flag_emits_empty_list_when_clean(lint_run, monkeypatch, capsys):
    monkeypatch.setattr(lint_all, "run_all", lambda: list(lint_run))
    assert main(["--json"]) == 0
    assert json.loads(capsys.readouterr().out) == []


def test_text_mode_prints_the_clean_line_naming_all_nine_lints(lint_run, monkeypatch, capsys):
    monkeypatch.setattr(lint_all, "run_all", lambda: list(lint_run))
    assert main([]) == 0
    assert capsys.readouterr().out.strip() == (
        "lint-all: metrics + storage + openapi + guard + parity + "
        "race-wiring + flow + boundary + schema clean")


def test_problems_as_json_splits_location():
    rows = problems_as_json([
        "guard: gpud_tpu_torch/storage/writer.py:41: self._pending read outside _cv",
        "openapi: served but undocumented: GET /v1/x",
        "schema: gpud_tpu_torch/tools/goldens/wire_schema.json: drift at "
        "predict.schema",
    ])
    assert rows[0] == {
        "lint": "guard",
        "file": "gpud_tpu_torch/storage/writer.py",
        "line": 41,
        "message": "self._pending read outside _cv",
    }
    assert rows[1]["lint"] == "openapi"
    assert rows[1]["file"] is None and rows[1]["line"] is None
    # golden drift problems anchor to the .json golden itself
    assert rows[2]["file"] == "gpud_tpu_torch/tools/goldens/wire_schema.json"
    assert rows[2]["line"] is None


# -- guard_lint on a deliberately broken module ------------------------------

BROKEN_GUARD_MODULE = '''\
import threading


class Broken:
    GUARDED_BY = {"_items": "_mu"}
    _LOCK_FREE = {"waived_ok": "snapshot read; torn values tolerated",
                  "waived_empty": "",
                  "waived_stale": "method never touches guarded state"}

    def __init__(self):
        self._mu = threading.Lock()
        self._items = []

    def locked_ok(self):
        with self._mu:
            self._items.append(1)

    def unlocked_violation(self):
        return len(self._items)

    def drain_locked(self):
        self._items.clear()

    def waived_ok(self):
        return list(self._items)

    def waived_empty(self):
        return list(self._items)

    def waived_stale(self):
        return 7
'''


def test_guard_lint_flags_broken_module(tmp_path):
    path = tmp_path / "broken.py"
    path.write_text(BROKEN_GUARD_MODULE)
    problems, waivers = guard_lint.lint_module(str(path), "broken.py")
    blob = "\n".join(problems)
    # the unlocked read is a violation; the locked/waived/_locked-suffix
    # and __init__ accesses are not
    assert "unlocked_violation" in blob
    assert "locked_ok" not in blob and "drain_locked" not in blob
    assert "__init__" not in blob
    # empty waiver reasons and waivers with zero violations are themselves
    # violations — stale escape hatches rot
    assert "waived_empty" in blob
    assert "waived_stale" in blob
    # the justified waiver surfaces in the report with its reason
    assert any("waived_ok" in w and "torn values tolerated" in w
               for w in waivers)


def test_guard_lint_requires_annotated_class(tmp_path):
    path = tmp_path / "bare.py"
    path.write_text("class NothingDeclared:\n    pass\n")
    problems, _ = guard_lint.lint_module(str(path), "bare.py")
    assert any("GUARDED_BY" in p for p in problems)


def test_guard_lint_real_modules_clean():
    problems, waivers = guard_lint.run_full()
    assert problems == []
    # every waiver printed carries a reason (the lint enforces non-empty,
    # this pins that they actually flow through to the report)
    assert waivers and all("—" in w for w in waivers)
    # the port's twelve threaded modules, each annotated
    assert len(guard_lint.GUARD_MODULES) == 12
    assert all(m.startswith("gpud_tpu_torch/") for m in guard_lint.GUARD_MODULES)


# -- parity_lint on a deliberately broken repo tree --------------------------

def _write(root, rel, text):
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(text)


def test_parity_lint_flags_dead_undocumented_unvalidated_knob(tmp_path):
    _write(tmp_path, "gpud_tpu_torch/config.py", (
        "class Config:\n"
        "    ghost_interval_seconds: int = 5\n"
        "    def validate(self):\n"
        "        return []\n"
    ))
    problems = parity_lint.config_problems(str(tmp_path))
    blob = "\n".join(problems)
    assert "dead knob" in blob
    assert "undocumented" in blob
    assert "never range-checks" in blob


def test_parity_lint_flags_unmatrixed_route(tmp_path):
    _write(tmp_path, "gpud_tpu_torch/server/app.py",
           'add("GET", "/v1/shiny-new", handler)\n')
    _write(tmp_path, "tests/test_http_route_matrix.py",
           'ROUTES_GET = ["/v1/states"]\n')
    problems = parity_lint.route_problems(str(tmp_path))
    assert any("/v1/shiny-new" in p and "no row" in p for p in problems)


def test_parity_lint_reads_the_ports_three_route_shapes(tmp_path):
    # add(...) in the local API, a (method, path, handler) table and a
    # Route(...) in the manager: every /v1 path is found, nothing else
    _write(tmp_path, "gpud_tpu_torch/server/app.py",
           'add("GET", "/v1/a", h)\nadd("POST", "/v1/b", h)\nadd("GET", "/metrics", h)\n')
    _write(tmp_path, "gpud_tpu_torch/manager/control_plane.py", (
        'table = [("GET", "/v1/c", self.c), ("POST", "/api/v1/login", self.d)]\n'
        'extra = Route("DELETE", "/v1/d", self.e, "doc")\n'))
    _write(tmp_path, "tests/test_http_route_matrix.py", "ROUTES = []\n")
    blob = "\n".join(parity_lint.route_problems(str(tmp_path)))
    for method, path in (("GET", "/v1/a"), ("POST", "/v1/b"), ("GET", "/v1/c"),
                         ("DELETE", "/v1/d")):
        assert f"{method} {path} has no row" in blob
    assert "/metrics" not in blob and "/api/v1/login" not in blob


def test_parity_lint_flags_dispatch_method_without_sdk_disposition(tmp_path):
    _write(tmp_path, "gpud_tpu_torch/session/dispatch.py", (
        "class Dispatcher:\n"
        "    def _m_brandNewVerb(self, p):\n"
        "        return {}\n"
    ))
    _write(tmp_path, "tests/test_dispatch_error_matrix.py",
           "MATRIX = []\n")
    _write(tmp_path, "gpud_tpu_torch/client/v1.py",
           "class Client:\n    pass\n")
    problems = parity_lint.dispatch_problems(str(tmp_path))
    blob = "\n".join(problems)
    # the new verb needs both a matrix row and an SDK disposition
    assert "'brandNewVerb' has no error-matrix row" in blob
    assert "'brandNewVerb' has no entry" in blob


# -- guard_lint waiver expiry (until: PR-N) ----------------------------------

EXPIRING_GUARD_MODULE = '''\
import threading


class Temp:
    GUARDED_BY = {"_items": "_mu"}
    _LOCK_FREE = {"expired_read": "snapshot ok until: PR-3 when shards land",
                  "current_read": "snapshot ok until: PR-900"}

    def __init__(self):
        self._mu = threading.Lock()
        self._items = []

    def expired_read(self):
        return list(self._items)

    def current_read(self):
        return list(self._items)
'''


def test_guard_lint_expired_waiver_fails(tmp_path):
    (tmp_path / "CHANGES.md").write_text("PR 9 earlier work\n")
    path = tmp_path / "temp.py"
    path.write_text(EXPIRING_GUARD_MODULE)
    problems, waivers = guard_lint.lint_module(
        str(path), "temp.py", root=str(tmp_path)
    )
    blob = "\n".join(problems)
    # CHANGES.md tops out at PR 9 → this is PR 10 → the PR-3 stamp is
    # long past; the PR-900 stamp is still a justified waiver
    assert "expired_read" in blob and "until: PR-3" in blob.replace("`", "")
    assert "current_read" not in blob
    assert any("current_read" in w for w in waivers)


def test_current_pr_number_is_changes_md_max_plus_one(tmp_path):
    (tmp_path / "CHANGES.md").write_text(
        "PR 1 one\nPR 12 twelve\nPR 3 three\n"
    )
    assert guard_lint.current_pr_number(str(tmp_path)) == 13


# -- boundary_lint -----------------------------------------------------------

BROKEN_BOUNDARY_MODULE = '''\
class Publisher:
    def bad_payload(self, outbox, comp):
        outbox.publish("health", {
            "component": comp,
            "probe": lambda: 1,
            "tags": {"a", "b"},
        })

    def bad_closure(self, payload):
        ex = self.ingest_executor
        ex.submit("m1", lambda: self._lock.acquire())

    def fine(self, session, payload):
        session.send(Frame(req_id="x", data=payload))
'''


def test_boundary_lint_flags_unserializable_payloads(tmp_path):
    path = tmp_path / "pub.py"
    path.write_text(BROKEN_BOUNDARY_MODULE)
    _problems, flagged, n_sites = boundary_lint.lint_module(
        str(path), "pub.py"
    )
    offenders = {(key, off) for _rel, key, off, _line in flagged}
    assert ("publish@bad_payload", "a lambda") in offenders
    assert ("publish@bad_payload", "a set literal") in offenders
    # the submitted closure drags a lock across the shard boundary
    assert ("submit-closure@bad_closure", "_lock") in offenders
    # the clean Frame site is counted but not flagged
    assert n_sites == 3
    assert not any("fine" in key for key, _ in offenders)


def test_boundary_lint_stale_waiver_is_an_error():
    waivers = {
        ("gpud_tpu_torch/daemon.py", "publish@never_exists", "*"):
            "points at nothing",
    }
    problems, _ = boundary_lint.run_full(waivers=waivers)
    assert any("stale waiver" in p for p in problems)


def test_boundary_lint_real_tree_clean():
    problems, _notes = boundary_lint.run_full()
    assert problems == []


def test_boundary_lint_lists_the_ports_seams():
    # the daemon publishes where the reference's Server did; every listed
    # module has a site, which run_full would report otherwise
    assert "gpud_tpu_torch/daemon.py" in boundary_lint.BOUNDARY_MODULES
    assert "gpud_tpu_torch/server/server.py" not in boundary_lint.BOUNDARY_MODULES
    for rel in boundary_lint.BOUNDARY_MODULES:
        assert boundary_lint.lint_module(os.path.join(REPO, rel), rel)[2] > 0, rel


# -- schema_lint golden drift ------------------------------------------------

def _mutated_golden(tmp_path, mutate):
    """Copy the real golden, apply ``mutate(view)``, return an absolute
    golden path usable as ``golden_rel`` (os.path.join ignores the root
    when the second component is absolute)."""
    real = os.path.join(schema_lint._repo_root(), schema_lint.GOLDEN_REL)
    with open(real, encoding="utf-8") as f:
        golden = json.load(f)
    mutate(golden["view"])
    path = tmp_path / "mutated_golden.json"
    path.write_text(json.dumps(golden))
    return str(path)


def test_schema_lint_real_tree_matches_golden():
    problems, notes = schema_lint.run_full()
    assert problems == []
    assert any("golden_version" in n for n in notes)


def test_the_ports_golden_view_equals_the_references():
    # the wire, journal and predict surfaces the two packages speak to each
    # other over are one surface: the port's frozen view is the reference's
    def view(rel):
        with open(os.path.join(REPO, rel), encoding="utf-8") as f:
            return json.load(f)["view"]

    ref = view("gpud_tpu/tools/goldens/wire_schema.json")
    port = view(schema_lint.GOLDEN_REL)
    assert schema_lint.GOLDEN_REL == "gpud_tpu_torch/tools/goldens/wire_schema.json"
    assert port == ref
    assert port["tables"]["journal"]["columns"]  # a real view, not two empties


def test_schema_lint_one_field_drift_fails(tmp_path):
    def bump_predict_schema(view):
        view["predict"]["schema"] = view["predict"]["schema"] + 1

    golden = _mutated_golden(tmp_path, bump_predict_schema)
    problems = schema_lint.run_full(golden_rel=golden)[0]
    assert any("schema drift at predict.schema" in p for p in problems)
    # the drift report tells the owner how to regenerate
    assert any("--update-goldens" in p for p in problems)


def test_schema_lint_renamed_journal_column_fails(tmp_path):
    def rename_column(view):
        cols = view["tables"]["journal"]["columns"]
        cols[cols.index("dedupe_key")] = "dedup_key"

    golden = _mutated_golden(tmp_path, rename_column)
    problems = schema_lint.run_full(golden_rel=golden)[0]
    assert any("tables.journal.columns" in p for p in problems)


def test_schema_lint_dropped_batch_field_fails(tmp_path):
    def drop_count(view):
        del view["batch"]["frame"]["outbox_batch"]["count"]

    golden = _mutated_golden(tmp_path, drop_count)
    problems = schema_lint.run_full(golden_rel=golden)[0]
    assert any("batch.frame.outbox_batch.count" in p for p in problems)


def test_schema_lint_missing_golden_demands_generation(tmp_path):
    problems = schema_lint.run_full(
        golden_rel=str(tmp_path / "nope.json")
    )[0]
    assert any("golden missing" in p and "--update-goldens" in p
               for p in problems)


def test_update_goldens_is_idempotent_and_bumps_on_change(tmp_path):
    # clean tree: regenerating the real golden writes nothing
    _path, changed = schema_lint.update_golden()
    assert changed is False
    # stale golden: regeneration rewrites it and bumps the version
    stale = _mutated_golden(
        tmp_path, lambda view: view["predict"].update(schema=99)
    )
    with open(stale, encoding="utf-8") as f:
        old_version = json.load(f)["golden_version"]
    path, changed = schema_lint.update_golden(golden_rel=stale)
    assert changed is True
    with open(path, encoding="utf-8") as f:
        fresh = json.load(f)
    assert fresh["golden_version"] == old_version + 1
    assert schema_lint.run_full(golden_rel=stale)[0] == []


def test_lint_all_update_goldens_flag(capsys):
    assert main(["--update-goldens"]) == 0
    assert "unchanged" in capsys.readouterr().out


# -- the race harness's wiring -----------------------------------------------

def test_race_wiring_objects_when_the_harness_loses_a_gate(tmp_path, monkeypatch):
    # a copy of the tree whose race.py lost its amplifier and whose smoke
    # script no longer calls it
    from gpud_tpu_torch.tools import guard_lint as gl

    race = os.path.join(REPO, "gpud_tpu_torch", "tools", "race.py")
    with open(race, encoding="utf-8") as f:
        src = f.read()
    _write(tmp_path, "gpud_tpu_torch/tools/race.py",
           src.replace("sys.setswitchinterval(GIL_SWITCH_INTERVAL_S)", "pass"))
    _write(tmp_path, "chip_smoke.py", "print('no race phase')\n")
    monkeypatch.setattr(gl, "_repo_root", lambda: str(tmp_path))
    blob = "\n".join(lint_all.race_harness_problems())
    assert "GIL-preemption amplifier" in blob
    assert "no longer runs tools/race.py" in blob


def test_openapi_parity_holds_on_the_ports_route_table():
    assert lint_all.openapi_parity_problems() == []
