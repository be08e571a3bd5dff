"""Organic kernel lines for the port's NVIDIA kmsg catalog, one or more per
entry (gpud_tpu_torch/components/gpu/catalog.py): the NVIDIA driver's Xid
lines, the NVSwitch driver's SXid lines, and the host-wide kernel lines of the
reference package's corpus (tests/test_catalog_organic.py) with the TPU
driver's tokens replaced by the NVIDIA driver's. Plain data, importing
nothing: tests/test_torch_xid_catalog.py holds the host-wide lines to the
reference's corpus, and chip_smoke.py replays all of them on the card."""

# entry name -> organic lines
ORGANIC = {
    "gpu_app_xid13": [
        "NVRM: Xid (PCI:0000:18:00): 13, pid=2714, name=python3, Graphics SM Warp Exception on (GPC 0, TPC 1, SM 0): Out Of Range Address",
        "NVRM: Xid (PCI:0000:18:00): 13, pid=2714, name=python3, Graphics Exception: ESR 0x504648=0x102000e 0x504650=0x0",
    ],
    "gpu_app_xid31": [
        "NVRM: Xid (PCI:0000:18:00): 31, pid=2714, name=python3, Ch 00000008, intr 00000000. MMU Fault: ENGINE GRAPHICS GPCCLIENT_T1_0 faulted @ 0x7f8a_00000000. Fault is of type FAULT_PDE ACCESS_TYPE_VIRT_READ",
    ],
    "gpu_app_xid43": [
        "NVRM: Xid (PCI:0000:18:00): 43, pid=2714, name=python3, Ch 00000010",
    ],
    "gpu_app_xid45": [
        "NVRM: Xid (PCI:0000:18:00): 45, pid=2714, name=python3, Ch 00000010",
    ],
    "gpu_ecc_xid48": [
        "NVRM: Xid (PCI:0000:18:00): 48, pid=2714, name=python3, An uncorrectable double bit error (DBE) has been detected on GPU in the framebuffer at partition 6, subpartition 0.",
    ],
    "gpu_ecc_xid94": [
        "NVRM: Xid (PCI:0000:18:00): 94, pid=2714, name=python3, Contained: SM (0x1). RST: No, D-RST: No",
    ],
    "gpu_ecc_xid95": [
        "NVRM: Xid (PCI:0000:18:00): 95, pid=2714, name=python3, Uncontained: FBHUB. RST: Yes, D-RST: No",
    ],
    "gpu_ecc_xid140": [
        "NVRM: Xid (PCI:0000:18:00): 140, pid='<unknown>', name=<unknown>, An unrecovered ECC error has been detected",
    ],
    "gpu_row_remap_xid63": [
        "NVRM: Xid (PCI:0000:18:00): 63, pid='<unknown>', name=<unknown>, Row Remapper: New row (0x000000000000da0e) Marked for Remapping, reset gpu to activate.",
    ],
    "gpu_row_remap_xid64": [
        "NVRM: Xid (PCI:0000:18:00): 64, pid='<unknown>', name=<unknown>, Row Remapper Error: remapping failed",
    ],
    "gpu_fallen_off_bus": [
        "NVRM: Xid (PCI:0000:18:00): 79, pid='<unknown>', name=<unknown>, GPU has fallen off the bus.",
        "NVRM: Xid (0000:3b:00): 79, pid=1, GPU has fallen off the bus.",
    ],
    "gpu_nvlink_error": [
        "NVRM: Xid (PCI:0000:18:00): 74, pid='<unknown>', name=<unknown>, NVLink: fatal error detected on link 7(0x0, 0x0, 0x10000, 0x0, 0x0, 0x0, 0x0)",
    ],
    "gpu_gsp_xid119": [
        "NVRM: Xid (PCI:0000:18:00): 119, pid=2714, name=python3, Timeout after 6s of waiting for RPC response from GPU0 GSP! Expected function 76 (GSP_RM_CONTROL) (0x20801702 0x4).",
    ],
    "gpu_gsp_xid120": [
        "NVRM: Xid (PCI:0000:18:00): 120, pid='<unknown>', name=<unknown>, GSP task exception: (cpuid=0x4) (mcause=0x1)",
    ],
    "gpu_nvswitch_fatal": [
        "nvidia-nvswitch2: SXid (PCI:0000:07:00.0): 20034, Fatal, Link 28 LTSSM Fault Up",
        "nvidia-nvswitch0: SXid (PCI:0000:05:00.0): 24007, Fatal, Link 32 SOE error",
    ],
    "gpu_nvswitch_nonfatal": [
        "nvidia-nvswitch0: SXid (PCI:0000:05:00.0): 12028, Non-fatal, Link 32 egress non-posted PRIV error (First)",
        "nvidia-nvswitch3: SXid (PCI:0000:08:00.0): 22013, Non-fatal, Link 46 Minion Link DLREQ interrupt",
    ],
    "gpu_edac_uncorrectable": [
        "EDAC MC0: 1 UE memory read error on chip 2",
        "EDAC MC0: 1 UE memory read error on CPU_SrcID#0_MC#0_Chan#0_DIMM#0 (channel:0 slot:0 page:0x2f8b00 offset:0x0 grain:32)",
    ],
    "gpu_edac_correctable": [
        "EDAC MC0: 7 CE memory scrub corrected",
        "EDAC MC0: 1 CE memory scrubbing error on CPU_SrcID#0_MC#0_Chan#1_DIMM#0 (channel:1 slot:0 page:0x12a offset:0x0 grain:32 syndrome:0x0)",
    ],
    "gpu_host_mce_memory": [
        "mce: [Hardware Error]: Machine Check: memory read error bank 5",
    ],
    "gpu_power_fault": [
        "nvidia0: power fault on 12V rail",
    ],
    "gpu_vrm_fault": [
        "VRM overcurrent on GPU socket 1",
    ],
    "gpu_thermal_trip": [
        "nvidia1: thermal throttle engaged at 96C",
    ],
    "gpu_power_throttle": [
        "power cap throttling engaged for package 0",
    ],
    "gpu_thermal_warning": [
        "nvidia0: temperature above warning threshold (88C)",
    ],
    "gpu_pcie_recovery_failed": [
        "pcieport 0000:00:04.0: AER: device recovery failed",
        "vfio-pci 0000:00:05.0: AER: device recovery failed",
    ],
    "gpu_vfio_aer_correctable": [
        "vfio-pci 0000:00:05.0: PCIe Bus Error: severity=Corrected, type=Physical Layer, (Receiver ID)",
        "vfio-pci 0000:00:05.0: AER: Corrected error received: 0000:00:05.0",
    ],
    "gpu_vfio_aer": [
        "vfio-pci 0000:00:05.0: PCIe Bus Error: severity=Uncorrected (Fatal), type=Transaction Layer, (Requester ID)",
        "vfio-pci 0000:00:05.0: AER: error status/mask=00100000/00000000",
    ],
    "gpu_pcie_uncorrectable": [
        "pcieport 0000:00:04.0: AER: Uncorrected (Fatal) error received: 0000:00:05.0",
        "pcieport 0000:00:04.0: AER: Multiple Uncorrected (Non-Fatal) error received: 0000:00:05.0",
    ],
    "gpu_pcie_slot_link_down": [
        "pciehp 0000:00:04.0:pcie004: Slot(0): Link Down",
        "pciehp 0000:00:04.0:pcie004: Slot(0): Card not present",
    ],
    "gpu_pcie_surprise_down": [
        "pcieport 0000:00:04.0: Surprise Down error",
    ],
    "gpu_pcie_completion_timeout": [
        "pcieport 0000:00:04.0: AER: Completion Timeout (First)",
    ],
    "gpu_pcie_dpc_containment": [
        "pcieport 0000:00:03.0: DPC: containment event, status:0x1f01 source:0x0000",
        "pcieport 0000:00:03.0: DPC: unmasked uncorrectable error detected",
    ],
    "gpu_pcie_link_downgrade": [
        "pcie 0000:00:04.0: link speed dropped to 8.0 GT/s",
        "vfio-pci 0000:00:05.0: 31.504 Gb/s available PCIe bandwidth, limited by 8.0 GT/s PCIe x4 link at 0000:00:03.0 (capable of 63.008 Gb/s with 16.0 GT/s PCIe x4 link)",
    ],
    "gpu_pcie_correctable": [
        "pcieport 0000:00:04.0: AER: Corrected error received",
    ],
    "gpu_dev_unbind_requested": [
        "vfio-pci 0000:00:05.0: Relaying device request to user (#0)",
        "nvidia 0000:00:04.0: driver unbind requested",
    ],
    "gpu_vfio_reset_recovery": [
        "vfio-pci 0000:00:05.0: vfio_bar_restore: reset recovery - restoring BARs",
    ],
    "gpu_iommu_fault": [
        "DMAR: [DMA Read] Request device [00:05.0] fault addr 0xfffff000",
        "DMAR: [DMA Read NO_PASID] Request device [00:05.0] fault addr 0x7f5a000000 [fault reason 0x06] PTE Read access is not set",
        "AMD-Vi: Event logged [IO_PAGE_FAULT device=00:05.0 domain=0x000a address=0xdeadbeef000 flags=0x0070]",
    ],
    "gpu_host_mem_ghes": [
        "{1}[Hardware Error]: section_type: memory error",
    ],
    "gpu_pcie_not_ready": [
        "vfio-pci 0000:00:05.0: not ready 65535ms after FLR; giving up",
        "nvidia 0000:00:04.0: not ready 1023ms after bus reset; giving up",
        "nvidia 0000:00:06.0: not ready 60000ms after resume; giving up",
    ],
    "gpu_pcie_flr_timeout": [
        "vfio-pci 0000:00:05.0: timed out waiting for pending transaction; performing function level reset anyway",
    ],
    "gpu_host_thermal_critical": [
        "thermal thermal_zone0: acpitz: critical temperature reached, shutting down",
        "critical temperature reached (128 C), shutting down",
    ],
}

# lines of a GPU host that must match no entry (the tests add the
# reference's benign host lines in NVIDIA tokens)
BENIGN = [
    "NVRM: loading NVIDIA UNIX x86_64 Kernel Module  580.159.03",
    "nvidia-nvswitch0: probing 0x22a3, minor 0",
    "nvidia 0000:18:00.0: enabling device (0000 -> 0002)",
    "nvidia-modeset: Loading NVIDIA Kernel Mode Setting Driver for UNIX platforms",
    "NVRM: GPU at PCI:0000:18:00: GPU-5bb6a0c2-0fa6-5d64-8f1e-b0a9c0d3c8c1",
    "NVRM: Xid (PCI:0000:18:00): 999, pid=1, name=x, something new",
    "NVRM: Xid (PCI:0000:18:00): 790, pid=1",
    "nvidia-nvswitch2: SXid (PCI:0000:07:00.0): 20034, Severity 1 Engine instance 28 Sub-engine instance 00",
    "nvidia-nvswitch2: SXid (PCI:0000:07:00.0): 20034, Data {0x00000000, 0x00000000}",
    "nvme 0000:c1:00.0: AER: Corrected error received: 0000:c1:00.0",
    "mlx5_core 0000:0c:00.0: AER: device recovery failed",
]
