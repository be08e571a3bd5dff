"""Seconds from the harness's start to the window: the host DBs written,
the program imported, its kernel built on first use, one warm sweep."""


def read(run):
    return run.setup_s
