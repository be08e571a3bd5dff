"""Resident memory the sweeps add, in MB (10**6 bytes): the highest
resident memory of the sweeping process and its children, sampled through
the window, less the same reading taken before the first sweep, once torch
and the CUDA context are loaded. What the libraries map is in both."""


def read(run):
    return (run.rss_peak_bytes - run.rss_base_bytes) / 1e6 if run.rss_peak_bytes else None
