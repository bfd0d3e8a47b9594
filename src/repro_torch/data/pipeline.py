"""Sharded host data pipeline with prefetch (reference:
``repro.data.pipeline``).

Determinism contract (elastic restarts): a batch is a pure function of
(seed, step, shard_id) — no generator state survives a restart, so
resuming at step S reproduces the stream a run that never failed saw.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

from repro_torch.utils import tree_map


def sharded_batches(make_batch: Callable[[int, int], dict], *, shard_id: int, start_step: int = 0) -> Iterator[dict]:
    """make_batch(step, shard_id) -> batch dict; an endless iterator."""
    step = start_step
    while True:
        yield make_batch(step, shard_id)
        step += 1


def prefetch(it: Iterator, size: int = 2) -> Iterator:
    """Background-thread prefetch (overlaps making the next batch with the
    device step); ends when ``it`` ends."""
    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        yield item


def microbatch_reshape(batch: dict, microbatches: int) -> dict:
    """Split every leaf's leading batch axis into (microbatches,
    B / microbatches)."""

    def r(x):
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(f"a batch of {b} does not split into {microbatches} microbatches")
        return x.reshape(microbatches, b // microbatches, *x.shape[1:])

    return tree_map(r, batch)
