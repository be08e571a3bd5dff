"""The port's helm chart (deployments/helm/tpud-torch), rendered with the
port's pure-Python subset renderer (gpud_tpu_torch/tools/helm_render.py),
YAML-parsed and shape-asserted, as tests/test_helm_render.py holds the
reference's chart: a DaemonSet running ``python -m gpud_tpu_torch run`` on
a GPU node pool, NVML through the NVIDIA container runtime, no card taken
from the jobs. The chart must stay within the renderer's documented
template subset: both renderers, the port's and the reference's, give it
the same text."""

import os

import pytest
import yaml

from gpud_tpu.tools import helm_render as ref_helm_render
from gpud_tpu_torch.tools.helm_render import TemplateError, main, render_chart

CHART = os.path.join(
    os.path.dirname(__file__), "..", "deployments", "helm", "tpud-torch"
)


def _daemonset(overrides=None, name="tpud-torch"):
    rendered = render_chart(CHART, release_name=name, overrides=overrides)
    body = rendered["daemonset.yaml"]
    doc = yaml.safe_load(body)  # a template typo breaks YAML → test fails
    assert doc is not None
    return doc


def test_default_render_shape():
    doc = _daemonset()
    assert doc["kind"] == "DaemonSet"
    assert doc["metadata"]["name"] == "tpud-torch"
    spec = doc["spec"]["template"]["spec"]
    assert spec["hostPID"] is True and spec["hostNetwork"] is True
    ct = spec["containers"][0]
    assert ct["image"] == "tpud-torch:0.1.0"
    assert ct["securityContext"]["privileged"] is True
    # the port's daemon, as its systemd unit runs it
    assert ct["command"] == ["python", "-m", "gpud_tpu_torch"]
    assert ct["args"][0] == "run"
    assert "--port=15132" in ct["args"]
    assert ct["livenessProbe"]["httpGet"]["path"] == "/healthz"
    # host surfaces the daemon needs: data dir, /dev (kmsg + nvidia*), /sys
    vols = {v["name"]: v for v in spec["volumes"]}
    assert vols["data"]["hostPath"]["path"] == "/var/lib/tpud"
    assert vols["dev"]["hostPath"]["path"] == "/dev"
    assert vols["sys"]["hostPath"]["path"] == "/sys"
    # GPU node-pool scheduling
    terms = spec["affinity"]["nodeAffinity"][
        "requiredDuringSchedulingIgnoredDuringExecution"
    ]["nodeSelectorTerms"]
    assert terms[0]["matchExpressions"][0] == {
        "key": "nvidia.com/gpu.present", "operator": "Exists"}
    assert spec["tolerations"] == [
        {"key": "nvidia.com/gpu", "operator": "Exists", "effect": "NoSchedule"}]


def test_nvml_without_taking_a_card():
    ct = _daemonset()["spec"]["template"]["spec"]["containers"][0]
    env = {e["name"]: e.get("value") for e in ct["env"]}
    assert env["NVIDIA_VISIBLE_DEVICES"] == "all"
    assert env["NVIDIA_DRIVER_CAPABILITIES"] == "utility"
    # the daemon watches the cards: it must not take one from the jobs
    for kind in ("requests", "limits"):
        assert "nvidia.com/gpu" not in ct["resources"].get(kind, {})


def test_both_renderers_give_the_chart_the_same_text():
    for overrides in (None, {"controlPlane.endpoint": "https://cp.example",
                             "controlPlane.sharedTokenSecret": "tpud-token",
                             "daemon.extraFlags": "['--pprof']"}):
        assert render_chart(CHART, "tpud-torch", overrides) == ref_helm_render.render_chart(
            CHART, "tpud-torch", overrides)


def test_render_cli_prints_every_template(capsys):
    assert main([CHART]) == 0
    out = capsys.readouterr().out
    assert out.startswith("---\n# Source: daemonset.yaml\n")
    assert yaml.safe_load(out.split("\n", 2)[2])["kind"] == "DaemonSet"


def test_default_render_omits_optional_env():
    doc = _daemonset()
    env = {e["name"] for e in doc["spec"]["template"]["spec"]["containers"][0]["env"]}
    assert "TPUD_ENDPOINT" not in env
    assert "TPUD_TOKEN" not in env


def test_control_plane_overrides_inject_env():
    doc = _daemonset(
        overrides={
            "controlPlane.endpoint": "https://cp.example",
            "controlPlane.sharedTokenSecret": "tpud-token",
        }
    )
    env = {
        e["name"]: e
        for e in doc["spec"]["template"]["spec"]["containers"][0]["env"]
    }
    assert env["TPUD_ENDPOINT"]["value"] == "https://cp.example"
    ref = env["TPUD_TOKEN"]["valueFrom"]["secretKeyRef"]
    assert ref["name"] == "tpud-token" and ref["key"] == "token"


def test_extra_flags_and_accelerator_type():
    doc = _daemonset(
        overrides={
            "daemon.acceleratorType": "h100-sxm-8",
            "daemon.extraFlags": "['--log-level=debug']",
        }
    )
    args = doc["spec"]["template"]["spec"]["containers"][0]["args"]
    assert "--accelerator-type=h100-sxm-8" in args
    assert "--log-level=debug" in args


def test_release_name_truncated_to_63():
    doc = _daemonset(name="x" * 80)
    assert doc["metadata"]["name"] == "x" * 63


def test_values_and_chart_parse_cleanly():
    for fname in ("values.yaml", "Chart.yaml"):
        with open(os.path.join(CHART, fname)) as f:
            assert yaml.safe_load(f)


def test_unsupported_construct_fails_loudly(tmp_path):
    # guard: the renderer must never silently emit an unrendered action
    chart = tmp_path / "c"
    (chart / "templates").mkdir(parents=True)
    (chart / "values.yaml").write_text("a: 1\n")
    (chart / "Chart.yaml").write_text("name: c\nversion: 0.0.1\n")
    (chart / "templates" / "bad.yaml").write_text(
        "x: {{ .Values.a | upper }}\n"
    )
    with pytest.raises(TemplateError):
        render_chart(str(chart))
