"""The port's sys.monitoring line-coverage tool (gpud_tpu_torch/tools/
cov.py), as tests/test_cov_tool.py holds the reference's: the stand-in for
the reference GPUd's go-test -cover CI gate. Its pytest hook is a plugin
(``-p gpud_tpu_torch.tools.cov`` with ``TPUD_TORCH_COV``), which refuses to
start beside the reference's conftest hook (``TPUD_COV``): the two cannot
share sys.monitoring's one coverage id."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from gpud_tpu_torch.tools import cov

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_executable_lines_includes_nested_defs(tmp_path):
    p = tmp_path / "m.py"
    p.write_text(
        textwrap.dedent(
            """\
            x = 1

            def f():
                def g():
                    return 2
                return g()

            class C:
                def m(self):
                    return 3
            """
        )
    )
    lines = cov.executable_lines(str(p))
    # assignment, both function bodies, and the method body are all present
    assert {1, 5, 6, 10} <= lines


def test_executable_lines_tolerates_syntax_errors(tmp_path):
    p = tmp_path / "bad.py"
    p.write_text("def broken(:\n")
    assert cov.executable_lines(str(p)) == set()


def test_ranges_compression():
    assert cov._ranges([]) == ""
    assert cov._ranges([3]) == "3"
    assert cov._ranges([1, 2, 3, 7, 9, 10]) == "1-3,7,9-10"


def test_collector_records_only_root_files(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    mod = pkg / "target.py"
    mod.write_text("def hit():\n    return 41\n\n\ndef missed():\n    return 0\n")
    sys.path.insert(0, str(pkg))
    try:
        c = cov.LineCollector(str(pkg))
        c.start()
        try:
            import target  # noqa: F401

            assert target.hit() == 41
        finally:
            c.stop()
        hit_files = {os.path.basename(f) for f in c.hits}
        assert "target.py" in hit_files
        (tfile,) = [f for f in c.hits if f.endswith("target.py")]
        assert 2 in c.hits[tfile]      # hit() body ran
        assert 6 not in c.hits[tfile]  # missed() body did not
    finally:
        sys.path.remove(str(pkg))
        sys.modules.pop("target", None)


def test_double_start_defers_to_existing_owner(tmp_path):
    a = cov.LineCollector(str(tmp_path))
    b = cov.LineCollector(str(tmp_path))
    a.start()
    try:
        b.start()  # must not raise "tool already in use"
        b.stop()   # no-op: b never owned the tool id
        assert sys.monitoring.get_tool(sys.monitoring.COVERAGE_ID) == "tpud-torch-cov"
    finally:
        a.stop()
    assert sys.monitoring.get_tool(sys.monitoring.COVERAGE_ID) is None


def test_foreign_tool_owner_degrades_to_no_coverage(tmp_path, capsys):
    """A debugger/profiler owning COVERAGE_ID must not crash the host
    process (conftest import) — coverage just disables itself."""
    sys.monitoring.use_tool_id(sys.monitoring.COVERAGE_ID, "other-profiler")
    try:
        c = cov.LineCollector(str(tmp_path))
        c.start()  # must not raise
        assert not c._active
        c.stop()   # no-op
        assert (
            sys.monitoring.get_tool(sys.monitoring.COVERAGE_ID)
            == "other-profiler"
        )
    finally:
        sys.monitoring.free_tool_id(sys.monitoring.COVERAGE_ID)


def test_dump_and_report_roundtrip(tmp_path):
    pkg = tmp_path / "proj"
    pkg.mkdir()
    (pkg / "mod.py").write_text("a = 1\nb = 2\n")
    c = cov.LineCollector(str(pkg))
    c.hits[str(pkg / "mod.py")] = {1}
    out = tmp_path / "cov.json"
    c.dump(str(out))
    data = json.loads(out.read_text())
    assert data["hits"][str(pkg / "mod.py")] == [1]

    reports = cov.build_report(str(out))
    (r,) = reports
    assert r.total == 2 and r.hit == 1 and r.missing == [2]
    assert r.pct == 50.0
    text = cov.format_report(reports, show_missing_for="mod.py")
    assert "50.0%" in text and "missing: 2" in text
    assert "TOTAL" in text


def test_report_skips_comment_and_blank_lines(tmp_path):
    pkg = tmp_path / "proj2"
    pkg.mkdir()
    (pkg / "m.py").write_text("# comment\n\nx = 1\n")
    c = cov.LineCollector(str(pkg))
    c.hits[str(pkg / "m.py")] = {3}
    out = tmp_path / "c.json"
    c.dump(str(out))
    (r,) = cov.build_report(str(out))
    assert r.total == 1 and r.hit == 1


def test_cli_report_entrypoint(tmp_path):
    pkg = tmp_path / "proj3"
    pkg.mkdir()
    (pkg / "m.py").write_text("x = 1\ny = 2\n")
    c = cov.LineCollector(str(pkg))
    c.hits[str(pkg / "m.py")] = {1, 2}
    out = tmp_path / "c.json"
    c.dump(str(out))
    res = subprocess.run(
        [sys.executable, "-m", "gpud_tpu_torch.tools.cov", "report", str(out)],
        capture_output=True,
        text=True,
        cwd=REPO,
        timeout=60,
    )
    assert res.returncode == 0
    assert "100.0%" in res.stdout


def test_cli_usage_on_bad_args():
    res = subprocess.run(
        [sys.executable, "-m", "gpud_tpu_torch.tools.cov"],
        capture_output=True,
        text=True,
        cwd=REPO,
        timeout=60,
    )
    assert res.returncode == 2


def _nested_pytest(test_file, **env_vars):
    """pytest with the plugin over ``test_file``, in a child whose
    environment has only the coverage variables given here."""
    env = {k: v for k, v in os.environ.items() if k not in ("TPUD_COV", cov.ENV_OUT)}
    env.update(env_vars)
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "gpud_tpu_torch.tools.cov", test_file],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300,
    )


def test_pytest_hook_produces_coverage(tmp_path):
    """e2e: the plugin through a real nested pytest run over one small
    port test file."""
    out = tmp_path / "cov.json"
    res = _nested_pytest("tests/test_torch_catalog_doc.py", TPUD_TORCH_COV=str(out))
    assert res.returncode == 0, res.stdout + res.stderr
    data = json.loads(out.read_text())
    assert data["root"] == os.path.join(REPO, "gpud_tpu_torch") + os.sep
    assert any(f.endswith(os.path.join("tools", "gen_catalog_doc.py")) for f in data["hits"])
    # only the port is collected, and the collector does not trace itself
    assert all(f.startswith(data["root"]) for f in data["hits"])
    assert not any(f.endswith("tools/cov.py") for f in data["hits"])


def test_the_plugin_refuses_to_start_beside_the_references_hook(tmp_path):
    """TPUD_COV makes tests/conftest.py take the coverage id for the
    reference package before the plugin configures: the run stops, saying
    why, and writes no report."""
    out = tmp_path / "cov.json"
    res = _nested_pytest("tests/test_torch_catalog_doc.py", TPUD_TORCH_COV=str(out),
                         TPUD_COV=str(tmp_path / "ref.json"))
    assert res.returncode != 0
    assert "held by the reference package's collector" in res.stdout + res.stderr
    assert not out.exists()


def test_a_collector_refuses_the_id_the_reference_holds(tmp_path):
    sys.monitoring.use_tool_id(sys.monitoring.COVERAGE_ID, cov.REFERENCE_TOOL_NAME)
    try:
        c = cov.LineCollector(str(tmp_path))
        with pytest.raises(RuntimeError, match="TPUD_COV"):
            c.start()
        assert not c._active
    finally:
        sys.monitoring.free_tool_id(sys.monitoring.COVERAGE_ID)
