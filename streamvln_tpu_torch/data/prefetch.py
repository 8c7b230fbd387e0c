"""Background batch prefetch: host-side data work and the upload to the
card overlap the train step.

Own copy of `streamvln_tpu/data/prefetch.py`, with the upload made here.
The reference stack overlaps JPEG decode and collation with the step
through DataLoader worker processes; one process driving one card does it
with a worker THREAD (PIL's decode and resize release the interpreter
lock). A bounded queue (`depth` batches) gives backpressure, so host
memory stays flat.

Upload (`device` a CUDA device): the worker copies each array of a batch
from pinned host memory on a side stream and records an event; `get`
makes the consumer's current stream wait on that event before anything
reads the batch, and marks each tensor as used on that stream
(`record_stream`), so the caching allocator does not hand its memory to
the side stream's next batch while the step still reads it. Without the
wait the step could read a batch still being copied: wrong losses, no
error.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Optional

import numpy as np
import torch


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


class BatchPrefetcher:
    """Iterates `index_batches` (re-iterated forever) in a background
    thread, mapping each index list through `make_batch` (load + collate),
    keeping up to `depth` prepared batches ahead of the consumer.

    device: None leaves batches as `make_batch` returns them; otherwise
    every numpy array or tensor value is moved to `device` (on a CUDA
    device by the worker, on a side stream, as described above).
    depth=0 is fully synchronous (no thread): for debugging and as the
    measurement baseline."""

    def __init__(self, index_batches: Iterable,
                 make_batch: Callable[[list], dict],
                 depth: int = 2, device=None):
        self.index_batches = index_batches
        self.make_batch = make_batch
        self.depth = depth
        self.device = None if device is None else torch.device(device)
        self._stream = torch.cuda.Stream(self.device) \
            if self.device is not None and self.device.type == "cuda" \
            and depth > 0 else None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if depth > 0:
            self._q: queue.Queue = queue.Queue(maxsize=depth)
            self._thread = threading.Thread(target=self._worker,
                                            daemon=True)
            self._thread.start()
        else:
            self._iter = self._indices()

    def _indices(self):
        while True:
            got_any = False
            for idx in self.index_batches:
                got_any = True
                yield idx
            if not got_any:
                raise RuntimeError("empty index_batches")

    def _upload(self, batch: dict):
        """(batch on self.device, the event the copies end with or None)."""
        if self.device is None:
            return batch, None

        def arrays(fn):
            return {k: fn(torch.as_tensor(v))
                    if isinstance(v, (np.ndarray, torch.Tensor)) else v
                    for k, v in batch.items()}
        if self._stream is None:
            return arrays(lambda t: t.to(self.device)), None
        with torch.cuda.stream(self._stream):
            out = arrays(lambda t: t.pin_memory().to(self.device,
                                                     non_blocking=True))
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _worker(self):
        try:
            for idx in self._indices():
                if self._stop.is_set():
                    return
                item = self._upload(self.make_batch(idx))
                while True:
                    try:
                        self._q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        if self._stop.is_set():
                            return
        except BaseException as e:  # noqa: BLE001 — re-raised in get()
            self._q.put(_Failure(e))

    def get(self) -> dict:
        """Next prepared batch, ready for the current stream; re-raises
        worker exceptions."""
        if self._thread is None:
            return self._upload(self.make_batch(next(self._iter)))[0]
        item = self._q.get()
        if isinstance(item, _Failure):
            raise item.exc
        batch, event = item
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for v in batch.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(current)
        return batch

    def close(self):
        self._stop.set()
        if self._thread is not None:
            # drain so a blocked put() sees the stop flag
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
