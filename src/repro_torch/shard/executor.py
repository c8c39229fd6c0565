"""Shard executor: thread-pool fan-out for per-shard work.

Port of ``repro/shard/executor.py``.  Here its one caller is the
maintenance scheduler (``core/maintenance.py``), whose flush and
compaction workers run on the pool while the writer and the readers go on.
numpy and the kernel launches release the GIL in their hot loops, so the
threads overlap for real.

``map`` runs inline when ``n_workers <= 1`` or there is a single item, so
exceptions and profiles look as they do without the pool; ``submit``
always uses the pool, even at ``n_workers=1``, because background jobs
must be asynchronous.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, TypeVar

T = TypeVar("T")
R = TypeVar("R")


class ShardExecutor:
    def __init__(self, n_workers: int):
        self.n_workers = max(1, int(n_workers))
        self._pool: Optional[ThreadPoolExecutor] = None

    def _ensure_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.n_workers,
                                            thread_name_prefix="shard")
        return self._pool

    def map(self, fn: Callable[[T], R], items: Sequence[T]) -> List[R]:
        """``fn`` over every item, in order; inline where the pool would
        not help (one worker or one item)."""
        if self.n_workers <= 1 or len(items) <= 1:
            return [fn(x) for x in items]
        return list(self._ensure_pool().map(fn, items))

    def submit(self, fn: Callable[..., R], *args) -> "Future[R]":
        """Run ``fn(*args)`` on the pool (the maintenance workers); always
        the real pool, even at ``n_workers=1``."""
        return self._ensure_pool().submit(fn, *args)

    def close(self) -> None:
        """Wait for the submitted jobs and stop the pool's threads."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self) -> "ShardExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
