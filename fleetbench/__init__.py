"""Benchmark of gpud_tpu_torch.fleet_scan: see run.py."""
