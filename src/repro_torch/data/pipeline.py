"""Training-data pipeline: host-side batching, one-deep prefetch onto the
device — the port's counterpart of ``repro.data.pipeline``.

The reference lays each batch out under the mesh's batch sharding; the
port has one card and no mesh, so a batch's arrays are moved to
``device`` whole.  A background thread builds the next batch while the
caller trains on this one, and batches come out in ``sample_fn``'s
order.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.models.model import resolve_device


class DataPipeline:
    def __init__(self, sample_fn: Callable[[int], Dict[str, np.ndarray]],
                 global_batch: int, prefetch: int = 1, device="cuda"):
        self.sample_fn = sample_fn
        self.global_batch = global_batch
        self.prefetch = prefetch
        self.device = resolve_device(device)
        self._buf: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def _make(self) -> Dict[str, Any]:
        host = self.sample_fn(self.global_batch)
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in host.items()}

    def _fill(self) -> None:
        while True:
            with self._lock:
                if len(self._buf) >= self.prefetch:
                    return
            batch = self._make()
            with self._lock:
                self._buf.append(batch)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return self

    def __next__(self) -> Dict[str, Any]:
        # a refill still running owns the next batch: join it first, or
        # this call would draw the batch after the one it is building
        if self._thread is not None:
            self._thread.join()
        with self._lock:
            nxt = self._buf.popleft() if self._buf else None
        if nxt is None:
            nxt = self._make()
        # kick off background refill
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()
        return nxt
