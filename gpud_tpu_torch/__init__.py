"""tpud's accelerator path in PyTorch and CUDA, for NVIDIA H100 hosts.

The package mirrors ``gpud_tpu``'s module names so each counterpart is easy
to find: ``fleet_scan`` (the fleet-wide link-health scan), ``ops.window_scan``
(the ragged scan and the health classes), ``ops.packed_scan`` (the packed
scan, whose CUDA kernel lives in ``csrc/packed_scan.cu``), ``models.anomaly``
(the robust scorer and the telemetry autoencoder), ``parallel.fleet`` (the
same analytics sharded over a device mesh), ``entry`` (``entry()`` and
``dryrun_multichip()``), ``gpu`` (the device adapter: NVML, the mock and the
torch backends), ``components`` (the GPU health checks) and ``scan`` (the
one-shot check table).

Entry points run on the card unless the caller passes ``device="cpu"``; see
:func:`gpud_tpu_torch.device.resolve_device`. Importing the package loads no
torch: the daemon's modules (``gpu``, ``components``, ``scan``) run without
it, and ``resolve_device`` imports it on first access.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from gpud_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
