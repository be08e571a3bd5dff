"""The port's custom plugins (gpud_tpu_torch/plugins/: specs and the checks
they run) against gpud_tpu's.

The reference's own tests — tests/test_plugins.py and
test_plugins_edge_cases.py — run on the port's modules
(tests/torch_ref_tests.py); the boot-leniency case boots the port's
``Daemon`` where it booted the reference's ``Server``. Then both packages
side by side: the same specs, drawn from a numpy seed, validate, serialize
and run to the same results; the CLI's ``custom-plugins``,
``run-plugin-group`` and ``list-plugins`` print the reference's lines; and
``yaml`` loads only where a specs file is read or written — without it the
daemon skips the file and boots."""

import base64
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from gpud_tpu.cli import main as ref_main
from gpud_tpu.components.base import TpudInstance as RefInstance
from gpud_tpu.plugins import component as ref_component
from gpud_tpu.plugins import spec as ref_spec

from gpud_tpu_torch.cli import main as port_main
from gpud_tpu_torch.components.base import TpudInstance as PortInstance
from gpud_tpu_torch.plugins import component as port_component
from gpud_tpu_torch.plugins import spec as port_spec

from torch_parity import stub_host_probes
from torch_ref_tests import port_tests

REPO = Path(__file__).resolve().parent.parent
SEED = 3

globals().update(port_tests("test_plugins.py"))
globals().update(port_tests("test_plugins_edge_cases.py", replace=[
    ("from gpud_tpu_torch.server.server import Server",
     "from gpud_tpu_torch.daemon import Daemon as Server")]))


@pytest.fixture(autouse=True)
def no_outside_probes(monkeypatch):
    """The boot case starts a daemon: its probes of the outside are stubbed."""
    stub_host_probes(monkeypatch)
    monkeypatch.setenv("TPUD_GPU_MOCK_ALL_SUCCESS", "1")


def spec_dicts(seed):
    """Plugin specs drawn from a numpy seed: scripts that pass, fail, print
    JSON for the parser, time out, fan out over a list."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(6):
        code = int(rng.integers(0, 3))
        value = int(rng.integers(0, 100))
        script = f'echo \'{{"temp": {value}, "state": "s{value % 3}"}}\'; exit {code}'
        d = {"name": f"probe-{i}", "plugin_type": "component", "run_mode": "auto",
             "interval_seconds": float(rng.integers(10, 600)), "timeout_seconds": 5.0,
             "tags": ["grp"] if i % 2 else ["other"],
             "parser": {"json_paths": {"t": "$.temp", "s": "$.state"},
                        "match_rules": [{"regex": "s1", "field": "s", "health": "Degraded",
                                         "suggested_actions": ["REBOOT_SYSTEM"],
                                         "description": "state one"}]}}
        if i == 3:
            d["steps"] = [{"name": "b64", "script_base64": base64.b64encode(
                script.encode()).decode()}]
        else:
            d["steps"] = [{"name": "s", "script": script}]
        if i == 5:
            d["plugin_type"] = "component_list"
            d["component_list"] = ["a", "b"]
            d["steps"] = [{"name": "s", "script": 'echo "item=$TPUD_PLUGIN_ITEM"'}]
        out.append(d)
    return out


def run(specs_mod, comp_mod, instance, dicts):
    specs = specs_mod.specs_from_list(dicts)
    rows = []
    for c in comp_mod.build_components(instance(), specs):
        cr = c.check()
        rows.append((c.name(), c.tags(), cr.health_state_type(), cr.summary(),
                     dict(cr.extra_info),
                     list(cr.suggested_actions.repair_actions) if cr.suggested_actions else []))
    return [s.to_dict() for s in specs], rows


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_specs_and_their_checks_are_the_reference_s(seed):
    dicts = spec_dicts(seed)
    ref = run(ref_spec, ref_component, RefInstance, dicts)
    port = run(port_spec, port_component, PortInstance, dicts)
    assert port == ref
    assert len(port[1]) == 7  # six specs, one fanned out over two items


@pytest.mark.parametrize("bad", [
    [{"name": "x"}], [{"steps": [{"script": "echo"}]}], "not-a-list",
    [{"name": "bad name!", "steps": [{"name": "s", "script": "echo"}]}],
    [{"name": "a", "steps": [{"name": "s", "script": "echo"}]},
     {"name": "a", "steps": [{"name": "s", "script": "echo"}]}],
    [{"name": "r", "steps": [{"name": "s", "script": "echo"}],
      "parser": {"match_rules": [{"regex": "("}]}}],
])
def test_invalid_specs_are_refused_as_the_reference(bad):
    errs = []
    for mod in (ref_spec, port_spec):
        try:
            mod.specs_from_list(bad)
            errs.append(None)
        except (ValueError, KeyError, TypeError, AttributeError) as e:
            errs.append((type(e).__name__, str(e)))
    assert errs[0] == errs[1] and errs[1] is not None


def test_the_cli_prints_the_reference_s_lines(tmp_path, capsys):
    good = tmp_path / "p.yaml"
    ref_spec.save_specs(str(good), ref_spec.specs_from_list(spec_dicts(SEED)))
    bad = tmp_path / "bad.yaml"
    bad.write_text("- name: 'bad name!'\n  steps: []\n")
    data = tmp_path / "data"
    data.mkdir()
    (data / "plugins.yaml").write_bytes(good.read_bytes())
    runs = [["custom-plugins", str(good)], ["custom-plugins", str(bad)],
            ["run-plugin-group", str(good), "--tag", "grp"], ["run-plugin-group", str(good)],
            ["list-plugins", "--data-dir", str(data)], ["list-plugins", "--data-dir", str(tmp_path)]]
    got = {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        outs = []
        for argv in runs:
            rc = main(argv)
            cap = capsys.readouterr()
            outs.append((rc, cap.out, cap.err))
        got[name] = outs
    assert got["port"] == got["ref"]
    assert [o[0] for o in got["port"]][:2] == [0, 1]


def test_the_spec_module_loads_yaml_only_to_read_or_write():
    code = textwrap.dedent("""
        import json, sys
        before = set(sys.modules)
        import gpud_tpu_torch.plugins.spec, gpud_tpu_torch.plugins.component
        print(json.dumps("yaml" in set(sys.modules) - before))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "false"


def test_without_yaml_the_daemon_skips_the_specs_file_and_boots(tmp_path, monkeypatch, caplog):
    from gpud_tpu_torch.config import default_config
    from gpud_tpu_torch.daemon import Daemon

    specs = tmp_path / "plugins.yaml"
    specs.write_text("- name: p\n  steps:\n    - {name: s, script: echo ok}\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    (tmp_path / "kmsg").touch()
    cfg = default_config(data_dir=str(tmp_path / "data"), kmsg_path=str(tmp_path / "kmsg"))
    cfg.plugin_specs_file = str(specs)
    d = Daemon(cfg)
    try:
        assert d.plugin_specs == [] and d.registry.get("p") is None
        assert any("skipping plugin specs file" in r.getMessage() for r in caplog.records)
    finally:
        d.stop()
