"""The port's kernel build (gpud_tpu_torch/ops/_build.py): what it reads back
from ptxas. The build itself needs nvcc and runs on the card's machine
(chip_smoke.py); its name, packaging and no-nvcc rules are in
tests/test_torch_port_rules.py."""

import pytest

from gpud_tpu_torch.ops import _build

# nvcc -Xptxas -v output for one sm_90a kernel in an anonymous namespace
PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__b6e35d99_14_packed_scan_cu_fd016a0118packed_scan_kernelEPKaPKiPKhlliPl' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__b6e35d99_14_packed_scan_cu_fd016a0118packed_scan_kernelEPKaPKiPKhlliPl
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 0 barriers
ptxas info    : Compile time = 46.379 ms
"""


def test_parse_ptxas_reads_registers_and_spills_by_kernel():
    assert _build.parse_ptxas(PTXAS) == {"packed_scan_kernel": {
        "registers": 56, "spill_stores": 0, "spill_loads": 0,
        "stack_bytes": 0, "smem_bytes": 0}}


def test_parse_ptxas_keeps_kernels_apart_and_reads_spills_and_smem():
    text = """\
ptxas info    : Compiling entry function '_Z1aPf' for 'sm_90a'
ptxas info    : Function properties for _Z1aPf
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 4096 bytes smem, 368 bytes cmem[0]
ptxas info    : Function properties for _Z6helperv
    24 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function 'plain_c_kernel' for 'sm_90a'
ptxas info    : Function properties for plain_c_kernel
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 12 registers, 360 bytes cmem[0]
"""
    got = _build.parse_ptxas(text)
    assert got["a"] == {"registers": 255, "spill_stores": 12, "spill_loads": 16,
                        "stack_bytes": 8, "smem_bytes": 4096}
    assert got["plain_c_kernel"]["registers"] == 12
    assert set(got) == {"a", "plain_c_kernel"}  # a device function is no kernel


@pytest.mark.parametrize("mangled, name", [
    ("_ZN12_GLOBAL__N_14scanEPKa", "scan"),
    ("_Z6kernelPf", "kernel"),
    ("_ZN2ns5inner3fooEv", "foo"),
    ("extern_c_kernel", "extern_c_kernel"),
])
def test_unqualified_kernel_names(mangled, name):
    assert _build._unqualified(mangled) == name


def test_nvcc_is_asked_for_the_ptxas_report():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "-Xptxas -v" in flags and "sm_90a" in flags
