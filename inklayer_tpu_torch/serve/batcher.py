"""Micro-batching for serving (port of :mod:`inklayer_tpu.serve.batcher`).

The reference serves requests strictly one after another.  Here concurrent
``/segment-sketch`` requests share one SAM ViT-H encoder launch: a worker
thread collects the encodes that arrive within ``max_wait_ms`` of the
first (up to the largest bucket), stacks them on the device, pads the
batch to the next bucket by repeating the last input, runs the batched
function once and hands each waiter its slice, still on the device.  An
exception reaches every waiter of that batch.

At B = 2 and 4 the encoder runs the relpos attention, MLP and LayerNorm
kernels at 2 and 4 times the tokens of one image.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Sequence

import torch

# the SAM encoder's batch sizes, and how long the first encode of a batch
# waits for others to join it; the web app runs at most the largest
# bucket's number of requests at once when it micro-batches
SAM_BATCH_BUCKETS = (1, 2, 4)
SAM_MAX_WAIT_MS = 10.0


class MicroBatcher:
    """``fn(batched (B, ...)) -> batched (B, ...)`` over tensors of one
    shape, B drawn from ``batch_buckets``.  ``launches`` counts the calls
    of ``fn`` per bucket, ``served`` the requests those calls served."""

    def __init__(self, fn: Callable, batch_buckets: Sequence[int],
                 max_wait_ms: float):
        self.fn = fn
        self.buckets = sorted(batch_buckets)
        self.max_wait = max_wait_ms / 1e3
        self.launches = {b: 0 for b in self.buckets}
        self.served = {b: 0 for b in self.buckets}
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="micro-batcher")
        self._thread.start()

    def submit(self, item: torch.Tensor) -> Future:
        fut: Future = Future()
        self._q.put((item, fut))
        return fut

    def __call__(self, item: torch.Tensor):
        return self.submit(item).result()

    def close(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=5)

    def _bucket_for(self, n: int) -> int:
        return next((b for b in self.buckets if n <= b), self.buckets[-1])

    def _collect(self):
        """The next batch of (item, future) pairs, or None to stop."""
        first = self._q.get()
        if first is None:
            return None
        batch = [first]
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.buckets[-1]:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                nxt = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:  # stop after this batch
                self._q.put(None)
                break
            batch.append(nxt)
        return batch

    def _worker(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            futs = [f for _, f in batch]
            try:
                n = len(batch)
                bucket = self._bucket_for(n)
                stacked = torch.stack([item for item, _ in batch])
                if bucket > n:
                    stacked = torch.cat(
                        [stacked, stacked[-1:].expand(bucket - n,
                                                      *stacked.shape[1:])])
                out = self.fn(stacked)
                self.launches[bucket] += 1
                self.served[bucket] += n
                for i, fut in enumerate(futs):
                    fut.set_result(out[i])
            except Exception as e:  # every waiter of the batch gets it
                for fut in futs:
                    if not fut.done():
                        fut.set_exception(e)


class BatchedSamEncoder:
    """A :class:`~inklayer_tpu_torch.models.sam.Sam` encoder behind a
    :class:`MicroBatcher`, shared by concurrent callers."""

    def __init__(self, model,
                 batch_buckets: Sequence[int] = SAM_BATCH_BUCKETS,
                 max_wait_ms: float = SAM_MAX_WAIT_MS):
        self.model = model
        self.batcher = MicroBatcher(self._encode, batch_buckets, max_wait_ms)

    def _encode(self, images: torch.Tensor) -> torch.Tensor:
        # inference mode is thread-local: the worker thread enters it
        with torch.inference_mode():
            return self.model.encode(images)

    def encode(self, preprocessed_image: torch.Tensor) -> torch.Tensor:
        """(S, S, 3) preprocessed image on the model's device -> its
        (G, G, C) embedding, on the device."""
        return self.batcher(preprocessed_image)

    def close(self) -> None:
        self.batcher.close()
