"""One function called on many argument tuples, side by side in child
interpreters.

Each child is a fresh interpreter (``python -c``, not a fork): it loads the
function's own module and what that imports, so nothing of the caller's
process (torch, a CUDA context, threads) is in it, and whatever memory the
calls take goes when it exits. A child ends with the thread that started
it, so a child's own children do not outlive it. Arguments and results
travel as pickles over its standard input and output. Standard library
only, so that the plain reference can use it and still import nothing but
its own package.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import subprocess
import sys
from typing import Callable, List, Optional, Sequence

CHILD = (
    "import ctypes, importlib, pickle, signal, sys\n"
    "ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG\n"
    "sys.path[:] = pickle.load(sys.stdin.buffer)\n"
    "module, name, calls = pickle.load(sys.stdin.buffer)\n"
    "fn = getattr(importlib.import_module(module), name)\n"
    "out = [fn(*args) for args in calls]\n"
    "pickle.dump(out, sys.stdout.buffer, pickle.HIGHEST_PROTOCOL)\n"
)


class ChildFailed(RuntimeError):
    """A child interpreter exited with an error; its standard error's end
    is in the message."""


def call_all(fn: Callable, calls: Sequence[tuple], workers: Optional[int] = None) -> list:
    """``[fn(*args) for args in calls]``: the calls dealt in turn to
    children, ``workers`` of them but at most one a core of this process and
    one a call; ``fn`` is looked up in the child by its module and name.
    Returns once every child has ended, and ends those still running if it
    is left early; a child that failed raises ``ChildFailed``."""
    name = f"{fn.__module__}.{fn.__qualname__}"
    n = min(len(calls), len(os.sched_getaffinity(0)), workers or len(calls))
    procs: List[subprocess.Popen] = []
    try:
        for _ in range(n):
            procs.append(subprocess.Popen([sys.executable, "-c", CHILD], stdin=subprocess.PIPE,
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        for i, p in enumerate(procs):
            try:  # a child that dies reading its calls is reported below
                pickle.dump(sys.path, p.stdin)
                pickle.dump((fn.__module__, fn.__qualname__, list(calls[i::n])), p.stdin,
                            pickle.HIGHEST_PROTOCOL)
                p.stdin.flush()
            except BrokenPipeError:
                pass
        outs = [p.communicate() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            for f in (p.stdout, p.stderr, p.stdin):
                with contextlib.suppress(OSError):  # stdin may hold what it could not send
                    f.close()
    for i, (p, (_out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise ChildFailed(f"{name}: child {i} of {n} exited {p.returncode}: "
                              f"{err.decode(errors='replace')[-2000:]}")
    got: list = [None] * len(calls)
    for i, (out, _err) in enumerate(outs):
        got[i::n] = pickle.loads(out)
    return got
