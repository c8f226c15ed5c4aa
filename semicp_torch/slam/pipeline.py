"""Stage-pipelined scan ingest: host I/O overlapped with device work.

Port of `semicp/slam/pipeline.py`, unchanged. On one device:

  stage 1  ingest (host thread): disk IO + label remap + host voxel
           downsample — pure numpy, runs in a background thread that
           never touches CUDA (its state is per thread)
  stage 2  preprocess (device, main thread): upload, canonical cm sort
           and covariances, queued on the stream without waiting
  stage 3  align (device, main thread): the EM loop, which reads one
           convergence flag per pass; by then stage 1 has the next scan

The pipeline changes scheduling only: alignment inputs and results are
bit-identical to the serial loop (the tests assert equality).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional


class ScanPrefetcher:
    """Run a scan-producing callable in a background thread, `depth`
    scans ahead of the consumer.

    `next_scan() -> item | None` is called repeatedly on the worker
    thread until it returns None (end of sequence) or raises. `get()`
    returns items in order, re-raising any producer exception at the
    consumption point (so failures surface where the serial loop would
    have hit them). depth=0 degrades to fully-serial calls on the
    consumer thread — the no-pipeline reference behavior.
    """

    _END = object()

    def __init__(self, next_scan: Callable[[], Optional[object]],
                 depth: int = 2):
        self._next_scan = next_scan
        self._depth = depth
        self._done = False
        if depth > 0:
            self._q: queue.Queue = queue.Queue(maxsize=depth)
            self._thread = threading.Thread(target=self._work, daemon=True)
            self._thread.start()

    def _work(self):
        try:
            while True:
                item = self._next_scan()
                if item is None:
                    self._q.put(self._END)
                    return
                self._q.put(item)
        except BaseException as e:  # surface at get()
            self._q.put(e)

    def get(self) -> Optional[object]:
        """Next scan, or None at (and after) end of sequence."""
        if self._done:
            return None
        if self._depth == 0:
            item = self._next_scan()
            self._done = item is None
            return item
        item = self._q.get()
        if item is self._END:
            self._done = True
            return None
        if isinstance(item, BaseException):
            self._done = True
            raise item
        return item

    def __iter__(self) -> Iterator[object]:
        while True:
            item = self.get()
            if item is None:
                return
            yield item
