"""The port's runtime and device-holder components
(gpud_tpu_torch/components/gpu/runtime.py) against the reference's
(gpud_tpu/components/tpu/runtime.py), case by case as in
tests/test_tpu_runtime_components.py: scripted systemd answers and staged
/proc trees, the same for both packages through the noun, unit and device
tables of tests/torch_parity.py."""

import ast
import os
import shutil

import pytest

import gpud_tpu.components.tpu.runtime as ref_rt
from gpud_tpu.components.base import TpudInstance as RefInstance
from gpud_tpu.tpu.instance import new_instance as ref_new_instance

import gpud_tpu_torch.components.gpu.runtime as rt
from gpud_tpu_torch.api.v1.types import HealthStateType, RepairActionType
from gpud_tpu_torch.components.base import TpudInstance
from gpud_tpu_torch.gpu.instance import new_instance

from torch_parity import (
    COMPONENTS,
    UNITS,
    actions,
    assert_gauges_parity,
    device_nodes,
    nouns,
    unit_names,
)


@pytest.fixture()
def instances(monkeypatch):
    monkeypatch.setenv("TPUD_GPU_MOCK_ALL_SUCCESS", "1")
    monkeypatch.setenv("TPUD_TPU_MOCK_ALL_SUCCESS", "1")
    return RefInstance(tpu_instance=ref_new_instance()), TpudInstance(gpu_instance=new_instance())


def _mapped_reason(ref_reason: str) -> str:
    text = device_nodes(unit_names(nouns(ref_reason)))
    head, sep, units = text.partition("runtime units healthy: ")
    if sep:  # the list is sorted by name, and the names differ
        text = head + sep + str(sorted(ast.literal_eval(units)))
    return text


def assert_same(ref_cr, port_cr):
    assert port_cr.component_name() == COMPONENTS[ref_cr.component_name()]
    assert port_cr.health == ref_cr.health, (ref_cr.reason, port_cr.reason)
    assert port_cr.reason == _mapped_reason(ref_cr.reason)
    if ref_cr.suggested_actions is None:
        assert port_cr.suggested_actions is None
    else:
        assert port_cr.suggested_actions.repair_actions == actions(
            ref_cr.suggested_actions.repair_actions)
        assert port_cr.suggested_actions.description == nouns(
            ref_cr.suggested_actions.description)
    assert port_cr.extra_info == {unit_names(k): device_nodes(v)
                                  for k, v in ref_cr.extra_info.items()}


# -- runtime units -------------------------------------------------------------


def _runtimes(instances, answers):
    ref_inst, port_inst = instances
    ref, port = ref_rt.TPURuntimeComponent(ref_inst), rt.GPURuntimeComponent(port_inst)
    ref.is_active_fn = lambda unit: answers.get(unit, "absent")
    port_answers = {UNITS[u]: s for u, s in answers.items()}
    port.is_active_fn = lambda unit: port_answers.get(unit, "absent")
    # the mock backend short-circuits check_once; these model a real host
    ref.tpu.is_mock = lambda: False
    port.gpu.is_mock = lambda: False
    return ref, port


RUNTIME_CASES = {
    "all units active": {"tpu-runtime.service": "active", "tpu-device-daemon.service": "active"},
    "failed unit": {"tpu-runtime.service": "failed"},
    "no units present": {},
    "inactive but present": {"tpu-device-daemon.service": "inactive"},
    "both failed": {"tpu-runtime.service": "failed", "tpu-device-daemon.service": "failed"},
}


@pytest.mark.parametrize("case", sorted(RUNTIME_CASES))
def test_runtime_units_match_the_reference(instances, case):
    ref, port = _runtimes(instances, RUNTIME_CASES[case])
    assert_same(ref.check_once(), port.check_once())


def test_runtime_probes_the_nvidia_units(instances):
    _ref, port = _runtimes(instances, {"tpu-runtime.service": "failed"})
    assert port.units == ["nvidia-fabricmanager.service", "nvidia-persistenced.service"]
    cr = port.check_once()
    assert cr.health == HealthStateType.UNHEALTHY
    assert "nvidia-fabricmanager.service" in cr.reason
    assert cr.suggested_actions.repair_actions == [RepairActionType.REBOOT_SYSTEM]


def test_runtime_mock_backend_short_circuits(instances):
    ref_inst, port_inst = instances
    ref, port = ref_rt.TPURuntimeComponent(ref_inst), rt.GPURuntimeComponent(port_inst)
    called = []
    ref.is_active_fn = port.is_active_fn = lambda unit: called.append(unit) or "failed"
    assert_same(ref.check_once(), port.check_once())
    assert called == []


def test_runtime_chaos_hook(instances):
    ref_inst, port_inst = instances
    ref, port = ref_rt.TPURuntimeComponent(ref_inst), rt.GPURuntimeComponent(port_inst)
    for c in (ref, port):
        c.time_now_fn = lambda: 100.0
        c.chaos_fail_until = 200.0
    assert_same(ref.check_once(), port.check_once())


class _R:
    def __init__(self, exit_code, output="", error=""):
        self.exit_code = exit_code
        self.output = output
        self.error = error


@pytest.mark.parametrize("result", [
    _R(0, "active\n"),
    _R(3, "inactive\n"),
    _R(3, "failed\n"),
    _R(4, "Unit x.service could not be found.\n"),
    _R(1, "", error="systemctl: not found"),
    _R(3, ""),
    # any other text is the unit's state, as the reference takes it
    _R(1, "Failed to connect to bus: Permission denied\n"),
    _R(3, "activating\n"),
], ids=["active", "inactive", "failed", "not-found", "no-systemctl", "empty",
        "other-error-text", "activating"])
def test_systemd_is_active_classification(monkeypatch, result):
    monkeypatch.setattr(ref_rt, "run_command", lambda *a, **k: result)
    monkeypatch.setattr(rt, "run_command", lambda *a, **k: result)
    assert rt.GPURuntimeComponent._systemd_is_active("x.service") == \
        ref_rt.TPURuntimeComponent._systemd_is_active("x.service")


def test_no_systemd_to_ask_is_absent(monkeypatch):
    # a container whose init is not systemd: systemctl explains itself on
    # stdout; the reference takes that text for the unit's state
    out = ("System has not been booted with systemd as init system (PID 1). Can't operate.\n"
           "Failed to connect to bus: Host is down\n")
    monkeypatch.setattr(rt, "run_command", lambda *a, **k: _R(1, out))
    monkeypatch.setattr(ref_rt, "run_command", lambda *a, **k: _R(1, out))
    assert rt.GPURuntimeComponent._systemd_is_active("x.service") == "absent"
    assert ref_rt.TPURuntimeComponent._systemd_is_active("x.service") == out.strip()


# -- device holders (/proc fd scan) ---------------------------------------------


def _stage_proc(root, pid, fd_targets, state="S", comm="python"):
    pid_dir = root / str(pid)
    fd_dir = pid_dir / "fd"
    fd_dir.mkdir(parents=True)
    for i, target in enumerate(fd_targets):
        os.symlink(target, fd_dir / str(i))
    (pid_dir / "stat").write_text(f"{pid} ({comm}) {state} 1 {pid} ...\n")
    return pid_dir


class Trees:
    """Two staged /proc trees, one per package: /dev/accelN in the
    reference's, /dev/nvidiaN in the port's."""

    def __init__(self, tmp_path):
        self.ref, self.port = tmp_path / "ref", tmp_path / "port"
        self.ref.mkdir()
        self.port.mkdir()

    def stage(self, pid, targets, **kw):
        _stage_proc(self.ref, pid, targets, **kw)
        _stage_proc(self.port, pid, [device_nodes(t) for t in targets], **kw)

    def write(self, rel, data: bytes):
        (self.ref / rel).write_bytes(data)
        (self.port / rel).write_bytes(data)

    def remove(self, rel):
        shutil.rmtree(self.ref / rel)
        shutil.rmtree(self.port / rel)


def _processes(instances, trees):
    ref_inst, port_inst = instances
    ref, port = ref_rt.TPUProcessesComponent(ref_inst), rt.GPUProcessesComponent(port_inst)
    ref.tpu.is_mock = lambda: False
    port.gpu.is_mock = lambda: False
    ref.proc_root, port.proc_root = str(trees.ref), str(trees.port)
    return ref, port


def _both(ref, port):
    r, p = ref.check_once(), port.check_once()
    assert_same(r, p)
    return p


def test_holders_found_from_fd_symlinks(instances, tmp_path):
    trees = Trees(tmp_path)
    trees.stage(100, ["/dev/accel0", "/dev/null", "/dev/accel1"])
    trees.stage(200, ["/dev/vfio/10"])
    trees.stage(300, ["/dev/null", "/tmp/x"])
    cr = _both(*_processes(instances, trees))
    assert cr.extra_info == {"100": "/dev/nvidia0,/dev/nvidia1", "200": "/dev/vfio/10"}


def test_stuck_holder_degrades_then_escalates(instances, tmp_path):
    trees = Trees(tmp_path)
    trees.stage(42, ["/dev/accel0"], state="D")
    ref, port = _processes(instances, trees)
    assert _both(ref, port).health == HealthStateType.DEGRADED
    second = _both(ref, port)
    assert second.health == HealthStateType.UNHEALTHY
    assert second.suggested_actions.repair_actions == [
        RepairActionType.CHECK_USER_APP_AND_GPU, RepairActionType.REBOOT_SYSTEM]


def test_stuck_holder_recovering_clears(instances, tmp_path):
    trees = Trees(tmp_path)
    trees.stage(42, ["/dev/accel0"], state="D")
    ref, port = _processes(instances, trees)
    assert _both(ref, port).health == HealthStateType.DEGRADED
    trees.write("42/stat", b"42 (python) S 1 42 ...\n")
    assert _both(ref, port).health == HealthStateType.HEALTHY


def test_different_pid_stuck_does_not_inherit_escalation(instances, tmp_path):
    trees = Trees(tmp_path)
    trees.stage(42, ["/dev/accel0"], state="D")
    ref, port = _processes(instances, trees)
    _both(ref, port)
    trees.remove("42")
    trees.stage(43, ["/dev/accel1"], state="D")
    cr = _both(ref, port)
    assert cr.health == HealthStateType.DEGRADED and "[43]" in cr.reason


def test_comm_with_parens_and_spaces_parsed(instances, tmp_path):
    trees = Trees(tmp_path)
    trees.stage(77, ["/dev/accel0"])
    trees.write("77/stat", b"77 (tpu) worker) D 1 77 ...\n")
    assert _both(*_processes(instances, trees)).health == HealthStateType.DEGRADED


def test_non_ascii_comm_does_not_crash_sweep(instances, tmp_path):
    trees = Trees(tmp_path)
    trees.stage(88, ["/dev/accel0"])
    trees.write("88/stat", b"88 (tpu\xff\xfeworker) D 1 88 ...\n")
    ref, port = _processes(instances, trees)
    assert port._proc_state(88) == ref._proc_state(88) == "D"
    trees.write("88/stat", b"88 (x) \xff 1 88 ...\n")
    assert port._proc_state(88) == ref._proc_state(88) == "?"
    _both(ref, port)


def test_broken_fd_symlinks_and_garbage_dirs_ignored(instances, tmp_path):
    trees = Trees(tmp_path)
    for root in (trees.ref, trees.port):
        (root / "55" / "fd").mkdir(parents=True)
        (root / "not-a-pid" / "fd").mkdir(parents=True)
    os.symlink("/dev/accel0", trees.ref / "55" / "fd" / "0")
    os.symlink("/dev/nvidia0", trees.port / "55" / "fd" / "0")
    os.symlink("/dev/accel9", trees.ref / "not-a-pid" / "fd" / "0")
    os.symlink("/dev/nvidia9", trees.port / "not-a-pid" / "fd" / "0")
    assert _both(*_processes(instances, trees)).extra_info == {"55": "/dev/nvidia0"}


def test_holder_gauge_tracks_count(instances, tmp_path):
    trees = Trees(tmp_path)
    trees.stage(101, ["/dev/accel0"])
    trees.stage(102, ["/dev/accel1"])
    _both(*_processes(instances, trees))
    assert assert_gauges_parity("accelerator-tpu-processes") == {
        ("tpud_gpu_device_holder_processes",
         (("component", "accelerator-gpu-processes"),)): 2.0}


def test_mock_backend_has_no_holders(instances, tmp_path):
    ref_inst, port_inst = instances
    _both(ref_rt.TPUProcessesComponent(ref_inst), rt.GPUProcessesComponent(port_inst))


@pytest.mark.parametrize("target, holds", [
    ("/dev/nvidia0", True),
    ("/dev/nvidia7", True),
    ("/dev/nvidia12", True),
    ("/dev/vfio/3", True),
    ("/dev/nvidiactl", False),
    ("/dev/nvidia-uvm", False),
    ("/dev/nvidia-uvm-tools", False),
    ("/dev/nvidia-modeset", False),
    ("/dev/nvidia-caps/nvidia-cap1", False),
    ("/dev/null", False),
])
def test_only_one_gpus_device_node_makes_a_holder(instances, tmp_path, target, holds):
    _stage_proc(tmp_path, 500, [target])
    port = rt.GPUProcessesComponent(instances[1])
    port.gpu.is_mock = lambda: False
    port.proc_root = str(tmp_path)
    cr = port.check_once()
    assert cr.extra_info == ({"500": target} if holds else {})
    assert cr.reason == f"{1 if holds else 0} process(es) holding GPU devices"
