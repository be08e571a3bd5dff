"""The port's NVIDIA Xid/SXid kmsg catalog (gpud_tpu_torch/components/gpu/catalog.py).

Every entry matches organic driver lines (the NVIDIA driver's ``NVRM: Xid``
lines, the NVSwitch driver's ``SXid`` lines) and its own injection line,
one test case per entry. The host-wide entries carried over from the
reference's catalog match the reference's organic lines
(tests/test_catalog_organic.py, with the TPU driver's tokens replaced by
the NVIDIA driver's) and keep the reference entries' severity, threshold
and repair actions. Lines of other devices and routine lines match nothing.
The lines are in tests/torch_xid_corpus.py, which chip_smoke.py replays on
the card."""

import pytest

from gpud_tpu.components.tpu import catalog as ref_catalog

from gpud_tpu_torch.api.v1.types import EventType, RepairActionType
from gpud_tpu_torch.components.gpu import catalog

from test_catalog_organic import BENIGN as REF_BENIGN
from test_catalog_organic import ORGANIC as REF_ORGANIC
from torch_parity import CATALOG_NAMES, actions, kernel_line
from torch_xid_corpus import BENIGN as GPU_HOST_BENIGN
from torch_xid_corpus import ORGANIC

PCI = "PCI:0000:18:00"

DRIVER = {n for n in ORGANIC if n not in CATALOG_NAMES.values()}
BENIGN = [kernel_line(ln) for ln in REF_BENIGN] + GPU_HOST_BENIGN


def test_host_wide_lines_are_the_references_in_nvidia_tokens():
    assert {n: ORGANIC[n] for n in CATALOG_NAMES.values()} == {
        CATALOG_NAMES[r]: [kernel_line(ln) for ln in REF_ORGANIC[r]] for r in CATALOG_NAMES}


def test_coverage_table_is_the_catalog():
    assert set(ORGANIC) == {e.name for e in catalog.CATALOG}
    assert len(catalog.CATALOG) == len(DRIVER) + len(CATALOG_NAMES) == 41


@pytest.mark.parametrize("name", sorted(ORGANIC))
def test_organic_lines_match_their_entry(name):
    for line in ORGANIC[name]:
        m = catalog.match(line)
        assert m is not None, f"no match for organic line: {line!r}"
        assert m.entry.name == name, f"{line!r} matched {m.entry.name}, expected {name}"


@pytest.mark.parametrize("name", sorted(ORGANIC))
def test_injection_line_round_trip(name):
    line = catalog.injection_line(name, gpu_id=3)
    assert line == f"GPU-ERR: {name} gpu=3"
    m = catalog.match(line)
    assert m is not None and m.entry.name == name and m.gpu_id == 3
    assert catalog.match(catalog.injection_line(name, 0, detail="burst 2/5")).gpu_id == 0


def test_injection_line_of_an_unknown_name_raises():
    with pytest.raises(KeyError):
        catalog.injection_line("tpu_chip_lost")


@pytest.mark.parametrize("line", BENIGN)
def test_benign_lines_do_not_match(line):
    m = catalog.match(line)
    assert m is None, f"{line!r} misclassified as {m.entry.name if m else ''}"


@pytest.mark.parametrize("ref_name", sorted(CATALOG_NAMES))
def test_host_wide_entry_keeps_the_references_classification(ref_name):
    ref, port = ref_catalog.lookup(ref_name), catalog.lookup(CATALOG_NAMES[ref_name])
    assert port.code == 1000 + ref.code
    assert (port.event_type, port.reboot_threshold, port.critical) == (
        ref.event_type, ref.reboot_threshold, ref.critical)
    assert list(port.repair_actions) == actions(ref.repair_actions)
    assert (port.exclude is None) == (ref.exclude is None)


def test_names_codes_and_the_nvlink_prefix():
    names = [e.name for e in catalog.CATALOG]
    codes = [e.code for e in catalog.CATALOG]
    assert len(set(names)) == len(names) and len(set(codes)) == len(codes)
    assert all(n.startswith("gpu_") for n in names)
    # the prefix that opens the NVLink component's fast-poll window
    assert [n for n in names if n.startswith("gpu_nvlink")] == ["gpu_nvlink_error"]
    for code, name in [(13, "gpu_app_xid13"), (48, "gpu_ecc_xid48"),
                       (74, "gpu_nvlink_error"), (79, "gpu_fallen_off_bus"),
                       (119, "gpu_gsp_xid119"), (catalog.SXID_FATAL, "gpu_nvswitch_fatal")]:
        assert catalog.lookup_code(code).name == name
        assert catalog.lookup(name).code == code
    assert catalog.lookup_code(999) is None and catalog.lookup("nope") is None
    assert catalog.lookup_code(20034) is None


# the reference package's entry whose classification each Xid/SXid entry
# takes (event type, repair actions, reboot threshold, critical): the same
# kind of fault on a TPU
XID_ANALOGS = {
    "gpu_app_xid13": "tpu_hbm_oom",
    "gpu_app_xid31": "tpu_hbm_oom",
    "gpu_app_xid43": "tpu_hbm_oom",
    "gpu_app_xid45": "tpu_hbm_oom",
    "gpu_ecc_xid48": "tpu_hbm_ecc_uncorrectable",
    "gpu_ecc_xid94": "tpu_hbm_ecc_uncorrectable",
    "gpu_ecc_xid95": "tpu_hbm_ecc_uncorrectable",
    "gpu_ecc_xid140": "tpu_hbm_ecc_uncorrectable",
    "gpu_fallen_off_bus": "tpu_chip_lost",
    "gpu_nvlink_error": "tpu_ici_link_down",
    "gpu_gsp_xid119": "tpu_driver_timeout",
    "gpu_gsp_xid120": "tpu_driver_crash",
    "gpu_nvswitch_fatal": "tpu_ici_port_error",
    "gpu_nvswitch_nonfatal": "tpu_ici_link_flap",
}
# left to the GPU memory check, as the reference GPUd leaves Xid 63/64 to
# its remapped-rows check
ROW_REMAP = ("gpu_row_remap_xid63", "gpu_row_remap_xid64")


def test_every_driver_entry_has_its_classification_source():
    assert set(XID_ANALOGS) | set(ROW_REMAP) == DRIVER
    assert not set(XID_ANALOGS) & set(ROW_REMAP)


@pytest.mark.parametrize("name", sorted(XID_ANALOGS))
def test_driver_entry_takes_its_reference_analogues_classification(name):
    port, ref = catalog.lookup(name), ref_catalog.lookup(XID_ANALOGS[name])
    assert (port.event_type, port.reboot_threshold, port.critical) == (
        ref.event_type, ref.reboot_threshold, ref.critical)
    assert list(port.repair_actions) == actions(ref.repair_actions)


@pytest.mark.parametrize("name", ROW_REMAP)
def test_row_remap_lines_are_left_to_the_memory_check(name):
    e = catalog.lookup(name)
    assert (e.event_type, e.repair_actions, e.reboot_threshold, e.critical) == (
        EventType.WARNING, (RepairActionType.IGNORE_NO_ACTION_REQUIRED,), 0, False)


ORDERING = [
    # an SXid is classed by its severity word: "Non-fatal" is not "fatal"
    ("nvidia-nvswitch2: SXid (PCI:0000:07:00.0): 20034, Fatal, Link 28 LTSSM Fault Up",
     "gpu_nvswitch_fatal"),
    ("nvidia-nvswitch2: SXid (PCI:0000:07:00.0): 20035, Fatal, Link 28 x", "gpu_nvswitch_fatal"),
    ("nvidia-nvswitch2: SXid (PCI:0000:07:00.0): 20034, Non-fatal, Link 28 x",
     "gpu_nvswitch_nonfatal"),
    # an Xid line wins over the host-wide formats its text also fits
    (f"NVRM: Xid ({PCI}): 48, pid=1, EDAC-like uncorrectable memory error", "gpu_ecc_xid48"),
    (f"NVRM: Xid ({PCI}): 79, pid=1, nvidia power fault", "gpu_fallen_off_bus"),
    # host-wide: uncorrectable before correctable, recovery-failed first
    ("EDAC MC0: 1 UE memory read error", "gpu_edac_uncorrectable"),
    ("EDAC MC0: 1 CE memory read error", "gpu_edac_correctable"),
    ("vfio-pci 0000:18:00.0: AER: device recovery failed", "gpu_pcie_recovery_failed"),
    ("vfio-pci 0000:18:00.0: PCIe Bus Error: severity=Corrected, type=Physical Layer",
     "gpu_vfio_aer_correctable"),
    ("vfio-pci 0000:18:00.0: PCIe Bus Error: severity=Uncorrected (Fatal)", "gpu_vfio_aer"),
]


@pytest.mark.parametrize("line, name", ORDERING)
def test_first_hit_ordering(line, name):
    assert catalog.match(line).entry.name == name


def test_prefilter_anchors_every_pattern_over_the_corpus():
    """The prefilter never rejects a line a pattern would match: every
    organic and injection line, in three casings."""
    for name, lines in ORGANIC.items():
        for line in lines + [catalog.injection_line(name, gpu_id=1)]:
            for variant in (line, line.upper(), line.lower()):
                assert catalog._PREFILTER.search(variant) is not None, variant
            assert catalog.match(line).entry.name == name


def test_prefilter_rejects_routine_lines():
    for line in ["audit: type=1400 apparmor=ALLOWED operation=open",
                 "systemd[1]: Started Daily apt download activities.",
                 "eth0: link becomes ready",
                 "EXT4-fs (sda1): mounted filesystem with ordered data mode"]:
        assert catalog._PREFILTER.search(line) is None and catalog.match(line) is None


# -- attribution -------------------------------------------------------------------

NVML_ADDRESSES = {0: "00000000:18:00.0", 1: "00000000:2A:00.0", 7: "00000000:DB:00.0"}


class _GPU:
    def __init__(self, pci_address):
        self.pci_address = pci_address


def _map(addresses=NVML_ADDRESSES):
    return catalog.bdf_map({g: _GPU(a) for g, a in addresses.items()})


def test_pci_key_reads_both_formats_alike():
    assert catalog.pci_key("0000:18:00") == catalog.pci_key("00000000:18:00.0") == (0, 0x18, 0)
    assert catalog.pci_key("0001:db:1f") == catalog.pci_key("00000001:DB:1F.3") == (1, 0xDB, 0x1F)
    assert catalog.pci_key("") is None and catalog.pci_key("not an address") is None


def test_bdf_map_leaves_out_gpus_without_an_address():
    m = catalog.bdf_map({0: _GPU("00000000:18:00.0"), 1: _GPU(""), 2: _GPU("[N/A]")})
    assert m == {(0, 0x18, 0): 0}


@pytest.mark.parametrize("line, gpu", [
    ("NVRM: Xid (PCI:0000:18:00): 79, pid=1, GPU has fallen off the bus.", 0),
    ("NVRM: Xid (PCI:0000:2a:00): 48, pid=1, DBE", 1),
    ("NVRM: Xid (PCI:0000:db:00): 74, pid=1, NVLink: fatal error detected on link 3", 7),
    ("NVRM: Xid (0000:db:00): 95, pid=1, Uncontained: FBHUB.", 7),
    ("vfio-pci 0000:2a:00.0: reset recovery - restoring BARs", 1),
    ("NVRM: Xid (PCI:0000:99:00): 79, pid=1, GPU has fallen off the bus.", None),
    ("nvidia-nvswitch2: SXid (PCI:0000:07:00.0): 20034, Fatal, Link 28 LTSSM Fault Up", None),
    ("GPU-ERR: gpu_fallen_off_bus gpu=5", 5),
])
def test_xid_lines_are_attributed_through_the_pci_map(line, gpu):
    m = catalog.match(line, _map())
    assert m is not None and m.gpu_id == gpu


def test_an_empty_map_leaves_xid_lines_host_wide():
    # NVML on some cards gives no PCI info: the map is empty
    line = "NVRM: Xid (PCI:0000:18:00): 79, pid=1, GPU has fallen off the bus."
    assert catalog.match(line, {}).gpu_id is None
    assert catalog.match(line).gpu_id is None
    assert catalog.extract_gpu("GPU-ERR: x gpu=2", {}) == 2
    assert catalog.extract_gpu("nvidia gpu4: x") == 4
    assert catalog.extract_gpu("no device here") is None
