"""The shared host worker pool of the delivery path.

One parallelism knob for Arrow delivery: ``TorchBatchParser`` owns an
:class:`AssemblyPool` whose worker count both (a) fans the per-column
Arrow assembly (``arrow_bridge.batch_to_arrow``) out over Python threads
and (b) gives the native memcpy fan-outs (``gather_spans_multi``,
``build_views``, ``views_interleave``) their thread budget, so the two
layers never oversubscribe each other: pooled per-column tasks run their
native calls single-threaded, unpooled batched calls get the whole
budget.  The parser also runs the host oracle's pass on a pool thread
while the query-string / cookie columns materialize.

Threads, not processes: the heavy steps (the native passes through
ctypes, numpy reductions, pyarrow buffer construction) release the GIL,
and the Arrow buffers must reference the batch's host memory without a
copy, which a process pool would force.

The port's own copy of the reference package's ``tpu/hostpool.py``
without its metrics calls (the port's observability is a later slice).
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Sequence

# Below this many rows the per-column fan-out costs more in task dispatch
# and GIL churn than it overlaps: smaller batches take the serial or
# batched path.
MIN_POOLED_ROWS = 32768

# View-mode column assembly is mostly small numpy / pyarrow work that
# holds the GIL (the byte-heavy stages are threaded inside the native
# calls), so fanning it out needs enough workers to hide the Python
# overhead.  Copy mode has no such floor: its per-column work is one
# GIL-released native gather.
VIEW_POOL_MIN_WORKERS = 4


def default_workers() -> int:
    """The delivery path's default parallelism: the native passes'
    default fan-out, min(8, cpu_count)."""
    from ..native import _default_threads

    return _default_threads()


class AssemblyPool:
    """A lazily started thread pool with a fixed worker count.

    ``workers == 1`` never starts a thread: every ``run_all`` runs serially
    in the caller, so a 1-wide pool is exactly the serial path."""

    def __init__(self, workers: Optional[int] = None):
        self.workers = max(1, int(workers if workers else default_workers()))
        self._executor: Optional[ThreadPoolExecutor] = None
        self._closed = False
        self._lock = threading.Lock()

    def _get_executor(self) -> Optional[ThreadPoolExecutor]:
        if self._executor is None:
            with self._lock:
                if self._closed:
                    return None   # terminal: never respawn after close()
                if self._executor is None:
                    self._executor = ThreadPoolExecutor(
                        max_workers=self.workers, thread_name_prefix="lp-assembly")
        return self._executor

    def run_all(self, tasks: Sequence[Callable[[], Any]]) -> List[Any]:
        """Run independent thunks; their results in order.  Serial when the
        pool is 1-wide, closed, or there is nothing to overlap; the first
        exception raised propagates either way."""
        if self.workers == 1 or len(tasks) <= 1:
            return [t() for t in tasks]
        ex = self._get_executor()
        if ex is None:
            return [t() for t in tasks]
        return list(ex.map(lambda t: t(), tasks))

    def submit(self, fn: Callable[[], Any]):
        """Run one thunk in the background: a Future, or None when the pool
        is 1-wide or closed (the caller then runs the thunk itself)."""
        if self.workers == 1:
            return None
        ex = self._get_executor()
        if ex is None:
            return None
        return ex.submit(fn)

    def close(self) -> None:
        """Terminal: later ``run_all`` calls run serially instead of
        starting threads again (a result kept past its parser still
        delivers ``to_arrow``)."""
        with self._lock:
            self._closed = True
            if self._executor is not None:
                self._executor.shutdown(wait=False)
                self._executor = None
