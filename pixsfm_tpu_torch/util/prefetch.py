"""Host-side async prefetch: overlap host work with device compute.

The reference keeps a mutex-guarded, refcounted H5 patch cache that worker
threads load from on demand (featureset.cc:56-160, featurepatch.h:31-79).
The batched equivalent (SURVEY.md §2.9) is a *pipeline*: while the
accelerator runs program N, a background thread prepares the host-side
inputs of program N+1 (image decode for extraction; chunk packing for the
chunked solvers). Kernel launches are already asynchronous — the
serialization this removes is the *host* work (PIL decode, numpy packing,
H5 reads) that otherwise sits between device launches.

Used by ``extract.features_from_image_list`` (image decode pipeline) and
``keypoint_adjustment.solver.solve_ka_problems`` (chunk packing pipeline).
Copy of ``pixsfm_tpu/util/prefetch.py``.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Sequence, TypeVar

T = TypeVar("T")
U = TypeVar("U")

__all__ = ["prefetch_map"]

_SENTINEL = object()


def prefetch_map(fn: Callable[[T], U], items: Sequence[T],
                 depth: int = 2) -> Iterator[U]:
    """Yield ``fn(item)`` in order, computing up to ``depth`` items ahead in
    a background thread.

    Exceptions raised by ``fn`` propagate to the consumer at the position of
    the failing item (the pipeline drains cleanly). KeyboardInterrupt on the
    consumer side stops the producer at the next item boundary — matching the
    chunk-boundary interrupt semantics of the solvers (the reference's
    PyInterrupt polls between work items, py_interrupt.h:12-38).

    ``depth <= 0`` disables prefetching (plain ordered map) — callers gate on
    a config knob without branching.
    """
    items = list(items)
    if depth <= 0 or len(items) <= 1:
        for it in items:
            yield fn(it)
        return

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def producer():
        try:
            for it in items:
                if stop.is_set():
                    return
                try:
                    q.put((False, fn(it)))
                except BaseException as e:  # noqa: BLE001 - relayed below
                    q.put((True, e))
                    return
        finally:
            q.put((False, _SENTINEL))

    th = threading.Thread(target=producer, daemon=True,
                          name="pixsfm-prefetch")
    th.start()
    try:
        while True:
            is_err, val = q.get()
            if is_err:
                raise val
            if val is _SENTINEL:
                return
            yield val
    finally:
        stop.set()
        # unblock the producer if it is waiting on a full queue
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        th.join(timeout=5.0)
