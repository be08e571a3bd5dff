"""Lock-order deadlock detection — the Python analog of `go test -race`.

The reference runs its whole suite under the Go race detector
(reference: scripts/tests-unit.sh:26-33). CPython's GIL hides data races
but NOT deadlocks: inconsistent lock acquisition order across threads is
the daemon's realistic concurrency hazard. This module instruments lock
creation so a stress run produces:

- the **lock-order graph**: edge A→B when a thread acquired B while
  holding A (with the first acquisition site per edge). A cycle in this
  graph is a potential deadlock even if the run never interleaved badly.
- **self-deadlock** reports: a thread blocking on a non-reentrant lock it
  already holds — a certain deadlock, raised immediately as
  :class:`DeadlockError` instead of hanging the test.

Usage (tests)::

    det = LockOrderDetector()
    with det.installed():          # patches threading.Lock/RLock
        ... exercise the daemon ...
    assert det.cycles() == []

Only locks *created* while installed are tracked; overhead per acquire is
one thread-local list append.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple


class DeadlockError(RuntimeError):
    """A thread blocked on a non-reentrant lock it already holds.

    ``held`` lists the thread's lock stack (oldest first) at the moment
    of the fatal acquire, so the traceback alone answers "holding what?"
    without a debugger attached to a hung test.
    """

    def __init__(self, msg: str, held: Optional[List[str]] = None):
        super().__init__(msg)
        self.held: List[str] = list(held or [])


class _Held(threading.local):
    def __init__(self) -> None:
        self.stack: List["_LockProxy"] = []


class _LockProxy:
    """Wraps a real lock; reports acquire ordering to the detector.

    Delegates everything else (``_is_owned``, ``_release_save``, ...) so
    ``threading.Condition`` keeps working over wrapped (R)Locks.
    """

    __slots__ = ("_lock", "_det", "name", "_reentrant")

    def __init__(self, lock, det: "LockOrderDetector", name: str, reentrant: bool):
        self._lock = lock
        self._det = det
        self.name = name
        self._reentrant = reentrant

    # -- instrumented interface -------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        self._det._before_acquire(self, blocking)
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._det._after_acquire(self)
        return got

    def release(self) -> None:
        self._det._on_release(self)
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lock.locked()

    # -- threading.Condition protocol -------------------------------------
    # Condition.wait() drops the lock via these instead of release(); the
    # held-stack must mirror that or waits would fabricate order edges.
    def _release_save(self):
        stack = self._det._held.stack
        depth = 0
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                depth += 1
        if hasattr(self._lock, "_release_save"):
            inner = self._lock._release_save()
        else:
            self._lock.release()
            inner = None
        return (inner, depth)

    def _acquire_restore(self, saved):
        inner, depth = saved
        if hasattr(self._lock, "_acquire_restore"):
            self._lock._acquire_restore(inner)
        else:
            self._lock.acquire()
        self._det._held.stack.extend([self] * depth)

    def _is_owned(self):
        if hasattr(self._lock, "_is_owned"):
            return self._lock._is_owned()
        # plain-Lock emulation (what Condition itself does when the lock
        # has no _is_owned)
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True

    def __getattr__(self, item):
        return getattr(self._lock, item)

    def __repr__(self) -> str:
        return f"<tracked {self.name} {self._lock!r}>"


def _creation_site(depth: int = 3) -> str:
    import sys

    try:
        f = sys._getframe(depth)
        return f"{f.f_code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno}"
    except Exception:  # noqa: BLE001
        return "?"


class LockOrderDetector:
    def __init__(self) -> None:
        # edge (held_name, acquired_name) → site string of first sighting
        self.edges: Dict[Tuple[str, str], str] = {}
        self.self_deadlocks: List[str] = []
        self._held = _Held()
        self._elock = threading.Lock()  # guards edges (a plain dict)
        self._installed = False
        self._orig: Optional[tuple] = None
        self._real_lock = threading.Lock
        self._real_rlock = threading.RLock
        self._wrapped_attrs: List[tuple] = []
        # raise immediately on certain deadlock (tests may disable to
        # collect everything first)
        self.raise_on_self_deadlock = True

    # -- proxy callbacks ---------------------------------------------------
    def _before_acquire(self, proxy: _LockProxy, blocking: bool) -> None:
        stack = self._held.stack
        if blocking and not proxy._reentrant and any(p is proxy for p in stack):
            site = _creation_site(depth=4)
            held = [p.name for p in stack]
            msg = (
                f"self-deadlock: {proxy.name} re-acquired at {site} "
                f"(held stack: {' -> '.join(held)})"
            )
            with self._elock:
                self.self_deadlocks.append(msg)
            if self.raise_on_self_deadlock:
                raise DeadlockError(msg, held=held)
        for held in stack:
            if held is proxy:
                continue
            key = (held.name, proxy.name)
            if key not in self.edges:
                with self._elock:
                    self.edges.setdefault(key, _creation_site(depth=4))

    def _after_acquire(self, proxy: _LockProxy) -> None:
        self._held.stack.append(proxy)

    def _on_release(self, proxy: _LockProxy) -> None:
        stack = self._held.stack
        # release in any order: remove the LAST occurrence (RLocks appear
        # once per recursion level)
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is proxy:
                del stack[i]
                break

    # -- installation ------------------------------------------------------
    def make_lock(self):
        return _LockProxy(
            self._real_lock(), self, f"Lock@{_creation_site(2)}", reentrant=False
        )

    def make_rlock(self):
        return _LockProxy(
            self._real_rlock(), self, f"RLock@{_creation_site(2)}", reentrant=True
        )

    def wrap_attr(self, obj, attr: str, name: str = "", reentrant: bool = False):
        """Replace an EXISTING lock attribute (e.g. a module-global created
        before install()) with a tracked proxy. Only safe while the lock is
        not concurrently held; returns the proxy."""
        lock = getattr(obj, attr)
        if isinstance(lock, _LockProxy):
            return lock
        proxy = _LockProxy(
            lock, self, name or f"{type(obj).__name__}.{attr}", reentrant
        )
        setattr(obj, attr, proxy)
        self._wrapped_attrs.append((obj, attr, lock))
        return proxy

    def unwrap_all(self) -> None:
        """Restore every wrap_attr replacement (call when done — a proxy
        left on a module global keeps feeding a dead detector)."""
        for obj, attr, lock in reversed(self._wrapped_attrs):
            setattr(obj, attr, lock)
        self._wrapped_attrs.clear()

    def install(self) -> None:
        """Patch threading.Lock/RLock so locks created from now on are
        tracked. Locks that already exist keep their real type."""
        if self._installed:
            return
        # capture current factories (they may already be another
        # detector's proxies in nested-instrument scenarios)
        self._real_lock = threading.Lock
        self._real_rlock = threading.RLock
        self._orig = (threading.Lock, threading.RLock)
        threading.Lock = self.make_lock  # type: ignore[assignment]
        threading.RLock = self.make_rlock  # type: ignore[assignment]
        self._installed = True

    def uninstall(self) -> None:
        if not self._installed:
            return
        threading.Lock, threading.RLock = self._orig  # type: ignore[misc]
        self._installed = False

    def installed(self):
        from contextlib import contextmanager

        @contextmanager
        def cm():
            self.install()
            try:
                yield self
            finally:
                self.uninstall()

        return cm()

    # -- analysis ----------------------------------------------------------
    def cycles(self) -> List[List[str]]:
        """Strongly-connected components of the lock-order graph with more
        than one lock — each is a potential deadlock. Tarjan (iterative,
        linear) — no size cap, so the acyclicity guarantee is total.
        Smallest first."""
        graph: Dict[str, Set[str]] = {}
        nodes: Set[str] = set()
        for a, b in self.edges:
            graph.setdefault(a, set()).add(b)
            nodes.add(a)
            nodes.add(b)

        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on_stack: Set[str] = set()
        stack: List[str] = []
        counter = [0]
        out: List[List[str]] = []

        def strongconnect(root: str) -> None:
            work: List[tuple] = [(root, iter(sorted(graph.get(root, ()))))]
            index[root] = low[root] = counter[0]
            counter[0] += 1
            stack.append(root)
            on_stack.add(root)
            while work:
                node, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack.add(w)
                        work.append((w, iter(sorted(graph.get(w, ())))))
                        advanced = True
                        break
                    if w in on_stack:
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    comp: List[str] = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.append(w)
                        if w == node:
                            break
                    if len(comp) > 1:
                        out.append(sorted(comp))

        for v in sorted(nodes):
            if v not in index:
                strongconnect(v)
        out.sort(key=len)
        return out

    def report(self, edges: bool = True) -> str:
        """Human-readable run summary: every observed order edge with the
        ``file:line`` where it was first acquired, cycles (if any) with
        their member edges, and self-deadlock sightings with held stacks.
        Pass ``edges=False`` to print only the problems."""
        lines = [f"{len(self.edges)} lock-order edges observed"]
        if edges:
            for (a, b), site in sorted(self.edges.items()):
                lines.append(f"  {a} -> {b} (first acquired at {site})")
        for cyc in self.cycles():
            # an SCC is a set, not a path — listing it with arrows would
            # imply acquisition edges that may not exist
            lines.append("CYCLE among locks: {" + ", ".join(cyc) + "}")
            members = set(cyc)
            for (a, b), site in sorted(self.edges.items()):
                if a in members and b in members:
                    lines.append(f"  edge {a} -> {b} (first seen at {site})")
        lines.extend(self.self_deadlocks)
        return "\n".join(lines)
