"""Async execution substrate: a process-wide thread pool.

Counterpart of `picha_tpu/runtime/executor.py`, of which this is a copy:
every async API call ``op(args..., cb)`` runs on the pool and invokes
``cb(err, result)`` from the worker thread (the reference library's
(err, result) convention), and also returns a Future. Host codec stages
release the GIL inside C calls (Pillow, zlib, numpy), and the device
work is asynchronous on its CUDA stream, so pool threads overlap.
PICHA_THREADS sets the pool's size (default: the core count, 4 to 32).
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional

_lock = threading.Lock()
_executor: Optional[ThreadPoolExecutor] = None


def get_executor() -> ThreadPoolExecutor:
    global _executor
    with _lock:
        if _executor is None:
            # at least 4: GIL-released C calls overlap even on few cores
            try:
                requested = int(os.environ.get("PICHA_THREADS", "0"))
            except ValueError:
                requested = 0
            workers = (requested if requested > 0
                       else min(32, max(4, os.cpu_count() or 4)))
            _executor = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="picha")
        return _executor


def run_async(fn: Callable, cb: Optional[Callable] = None) -> Future:
    """Run fn() on the pool; deliver (err, result) to cb; return a Future.

    The callback runs INSIDE the worker task, never inline in the
    submitting thread: add_done_callback would invoke it synchronously
    when the task finishes before the callback attaches, deadlocking
    callers that hold a lock across run_async and re-take it in cb
    (libuv — the semantics this replaces — always delivers async)."""
    if cb is None:
        return get_executor().submit(fn)

    fut: Future = Future()

    def task():
        try:
            result = fn()
        except Exception as e:  # noqa: BLE001 — error-callback convention
            try:
                cb(e, None)
            finally:
                fut.set_exception(e)
        else:
            try:
                cb(None, result)
            finally:
                fut.set_result(result)

    get_executor().submit(task)
    return fut
