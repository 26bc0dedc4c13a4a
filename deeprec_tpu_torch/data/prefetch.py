"""Staged input pipeline: a host thread that keeps batches in flight — the
port's own copy of `deeprec_tpu/data/prefetch.py` (`Prefetcher`, `staged`).

A background thread pulls batches from the reader, runs `transform` on each
(the trainer's `stage_batch`: trim to the model's inputs and start the copy
to the card on a copy stream) and keeps up to `depth` of them in a queue
while the train loop consumes the previous one. The consumer's waits on an
empty queue are the input stall: kept on the object (`stall_seconds`,
`stalls`) and reported per wait to the metrics plane
(`deeprec_input_stall_seconds{site="staged"}`, `data/pipeline.record_stall`).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from deeprec_tpu_torch import resolve_device
from deeprec_tpu_torch.data.pipeline import record_stall


def _to_device(batch, device):
    return {k: torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v)).to(device)
            for k, v in batch.items()}


class Prefetcher:
    """Wrap a host batch iterator; keep `depth` transformed batches ready.

    on_consume: called in the CONSUMER thread each time a batch is
    delivered by __next__. The ring runs `depth` batches ahead of the train
    loop, so a reader's own position overstates progress by the in-flight
    count; stream-position checkpoints track deliveries (wire the reader's
    `mark_consumed` here, or let `Trainer.stage` do it).

    transform: applied in the producer thread to each raw batch; the
    default copies every array to `device` (the card unless asked for the
    CPU).

    peek: called in the PRODUCER thread on each raw host batch before
    `transform`, while the batch still waits in the host queue — the tier
    paging tap (`TierPrefetcher.observe`). It must be cheap; an exception
    it raises reaches the consumer as a reader error and ends the
    stream."""

    def __init__(
        self,
        source: Iterator[Dict[str, np.ndarray]],
        depth: int = 2,
        transform: Optional[Callable] = None,
        on_consume: Optional[Callable] = None,
        device=None,
        peek: Optional[Callable] = None,
    ):
        self.source = iter(source)
        self.depth = max(1, depth)
        if transform is None:
            dev = resolve_device(device)
            transform = lambda b: _to_device(b, dev)  # noqa: E731
        self.transform = transform
        self.on_consume = on_consume
        self.peek = peek
        self.q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self.stall_seconds = 0.0  # consumer wait on an empty ring (total)
        self.stalls = 0  # deliveries that had to wait
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Enqueue with a timed put that re-checks the stop flag, so a full
        queue never strands the worker after close(). True = delivered."""
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for batch in self.source:
                if self._stop.is_set():
                    return
                if self.peek is not None:
                    self.peek(batch)
                if not self._put(self.transform(batch)):
                    return
            self._put(None)
        except Exception as e:  # surface reader errors to the consumer
            if self._put(e):
                self._put(None)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            item = self.q.get_nowait()
        except queue.Empty:
            # an empty ring: the producer (reader, transform) is the
            # bottleneck right now
            t0 = time.perf_counter()
            item = self.q.get()
            wait = time.perf_counter() - t0
            self.stall_seconds += wait
            self.stalls += 1
            record_stall("staged", wait)
        if item is None:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        if self.on_consume is not None:
            self.on_consume()
        return item

    def close(self):
        """Stop the worker: set the stop flag (its timed put sees it), drain
        the queue so an in-flight put can land, join the thread, and drain
        again so nothing keeps a staged batch alive."""
        self._stop.set()
        self._drain()
        self._thread.join(timeout=2.0)
        self._drain()

    def _drain(self):
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass


def staged(source, depth: int = 2, transform=None, on_consume=None,
           device=None, peek=None) -> Prefetcher:
    """`for batch in staged(reader): ...`."""
    return Prefetcher(source, depth=depth, transform=transform,
                      on_consume=on_consume, device=device, peek=peek)
