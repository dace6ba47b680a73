"""Micro-batched multimodal serving: the port of
``fengshen_tpu/serving/multimodal.py``.

The continuous-batching engine is token-autoregressive; a diffusion
UNet's unit of work is one whole denoise loop per request. What such a
workload wants is micro-batching: requests that arrive within a short
gather window ride one batch. :class:`BatchImageEngine`
(``engine_type="batch_image"``, text to image through
``pipelines/image_generation.py``) holds the bounded queue, the gather
window, the worker thread, warmup, drain, cancel and ``/stats``, and
hands the model work to the pipeline's ``run_batch(inputs) ->
list[result]`` hook. Admission raises what the
continuous engine raises (``QueueFull`` -> 429, ``Draining`` -> 503,
``DuplicateRequest`` -> 409), so the API layer maps both alike.

``EmbeddingEngine`` is not yet ported: its pipeline
(``pipelines/embedding.py``, the Taiyi CLIP text tower) is not, and
:func:`create_multimodal_engine` raises ``NotImplementedError`` for it.

As the port's continuous engine does, a micro-batch engine stops for
good after a failed warmup (:meth:`BatchImageEngine.fail`): submissions
then raise ``EngineStopped`` (503) and ``/healthz`` reports it.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Optional

from fengshen_tpu_torch.serving.engine import (Draining, DuplicateRequest,
                                               EngineStopped, QueueFull)

#: request states (the continuous engine's richer states would be a
#: false equivalence: this engine has no slots or evacuation)
MM_QUEUED = "queued"
MM_FINISHED = "finished"
MM_FAILED = "failed"
MM_CANCELLED = "cancelled"


class MMRequest:
    """One submitted request; :meth:`wait` blocks the HTTP handler's
    thread until the worker answers it."""

    def __init__(self, request_id: str, payload: Any):
        self.request_id = request_id
        self.payload = payload
        self.result: Any = None
        self.error: Optional[str] = None
        self.state = MM_QUEUED
        self._done = threading.Event()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def _finish(self, result: Any) -> None:
        self.result = result
        self.state = MM_FINISHED
        self._done.set()

    def _fail(self, error: str) -> None:
        self.error = error
        self.state = MM_FAILED
        self._done.set()

    def _cancel(self, reason: str) -> None:
        self.error = reason
        self.state = MM_CANCELLED
        self._done.set()


class BatchImageEngine:
    """Gather-window micro-batching over ``pipeline.run_batch``: for
    text to image (Taiyi Stable Diffusion) each batch is one denoise
    loop and VAE decode over its riders' prompts.

    ``max_batch`` bounds one batch; ``gather_ms`` is how long the worker
    waits for co-riders after the first request of a batch lands (0:
    take what is queued). ``clock`` is injectable for tests."""

    engine_type = "batch_image"

    def __init__(self, pipeline: Any, max_batch: int = 4,
                 gather_ms: float = 2.0, max_queue: int = 64,
                 log=None, clock=time.monotonic):
        if not hasattr(pipeline, "run_batch"):
            raise ValueError(
                f"engine {self.engine_type!r} needs a pipeline exposing "
                "run_batch(inputs) -> list[result] (task "
                "'image_generation'), not a per-call text pipeline")
        self.pipeline = pipeline
        self.max_batch = int(max_batch)
        self.gather_ms = float(gather_ms)
        self.max_queue = int(max_queue)
        self._log = log or (lambda *a, **k: None)
        self._clock = clock
        self._t0 = clock()
        self._cv = threading.Condition()
        self._queue: list[MMRequest] = []
        #: request_id -> live request (the 409 dedupe)
        self._live: "OrderedDict[str, MMRequest]" = OrderedDict()
        self._in_flight = 0
        self._draining = False
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._counter = 0
        self._requests_total = 0
        self._batches_total = 0
        self._batched_requests = 0
        self._warmup_s: Optional[float] = None
        self._fatal: Optional[BaseException] = None
        self._fatal_what = ""

    # ---- lifecycle --------------------------------------------------

    def warmup(self) -> float:
        """One batch of ``max_batch`` warmup inputs through the pipeline
        (the width the engine serves at most); returns seconds."""
        t0 = time.perf_counter()
        self.pipeline.run_batch([self.pipeline.warmup_input()]
                                * self.max_batch)
        self._warmup_s = time.perf_counter() - t0
        return self._warmup_s

    def start(self) -> None:
        with self._cv:
            if self._running:
                return
            self._running = True
        self._thread = threading.Thread(
            target=self._serve_loop, daemon=True,
            name=f"fstpu-{self.engine_type}")
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        with self._cv:
            self._running = False
            for req in self._queue:
                req._cancel("engine stopped")
            self._queue.clear()
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def fail(self, error: BaseException, what: str) -> None:
        """Stop serving for good (a failed warmup): queued requests are
        cancelled and later submissions raise ``EngineStopped``."""
        with self._cv:
            self._fatal, self._fatal_what = error, what
        self.stop()

    def stopped_reason(self) -> Optional[str]:
        if self._fatal is None:
            return None
        return (f"engine stopped after {self._fatal_what}: "
                f"{type(self._fatal).__name__}: {self._fatal}")

    # ---- admission --------------------------------------------------

    def submit(self, payload: Any,
               request_id: Optional[str] = None) -> MMRequest:
        if payload is None or (isinstance(payload, str)
                               and not payload.strip()):
            raise ValueError("empty input")
        with self._cv:
            if self._fatal is not None:
                raise EngineStopped(self.stopped_reason())
            if self._draining:
                raise Draining("replica draining")
            if request_id is not None and request_id in self._live:
                raise DuplicateRequest(
                    f"request_id {request_id!r} already in flight")
            if len(self._queue) >= self.max_queue:
                raise QueueFull(f"queue full ({self.max_queue} requests)")
            if request_id is None:
                self._counter += 1
                request_id = f"{self.engine_type}-{self._counter}"
            req = MMRequest(str(request_id), payload)
            self._queue.append(req)
            self._live[req.request_id] = req
            self._requests_total += 1
            self._cv.notify_all()
            return req

    def cancel(self, request_id: str) -> bool:
        """Cancel a queued request; False once the worker took it."""
        with self._cv:
            req = self._live.get(request_id)
            if req is None or req.state != MM_QUEUED or \
                    req not in self._queue:
                return False
            self._queue.remove(req)
            req._cancel("cancelled")
            self._live.pop(request_id, None)
            return True

    # ---- drain / idle -----------------------------------------------

    def begin_drain(self) -> None:
        with self._cv:
            self._draining = True
            self._cv.notify_all()

    def idle(self) -> bool:
        with self._cv:
            return not self._queue and self._in_flight == 0

    # ---- worker -----------------------------------------------------

    def _take_batch(self) -> list[MMRequest]:
        """Under ``_cv``: wait for work, then gather up to ``max_batch``.
        The gather window only ever delays the first rider of a batch."""
        while self._running and not self._queue:
            self._cv.wait(0.05)
        if not self._running:
            return []
        if self.gather_ms > 0 and len(self._queue) < self.max_batch:
            deadline = self._clock() + self.gather_ms / 1000.0
            while (self._running and len(self._queue) < self.max_batch
                   and self._clock() < deadline):
                self._cv.wait(self.gather_ms / 1000.0)
        batch = self._queue[:self.max_batch]
        del self._queue[:len(batch)]
        self._in_flight += len(batch)
        return batch

    def _serve_loop(self) -> None:
        while True:
            with self._cv:
                if not self._running:
                    return
                batch = self._take_batch()
            if not batch:
                continue
            try:
                results = self.pipeline.run_batch(
                    [r.payload for r in batch])
                if len(results) != len(batch):
                    raise ValueError(
                        f"run_batch returned {len(results)} results "
                        f"for {len(batch)} inputs")
                for req, res in zip(batch, results):
                    req._finish(res)
            except Exception as e:  # noqa: BLE001 - a bad batch answers
                # its requests; the worker lives on
                self._log(f"[{self.engine_type}] batch failed: {e}")
                for req in batch:
                    req._fail(str(e)[:500])
            finally:
                with self._cv:
                    self._in_flight -= len(batch)
                    self._batches_total += 1
                    self._batched_requests += len(batch)
                    for req in batch:
                        self._live.pop(req.request_id, None)

    # ---- observability ----------------------------------------------

    def stats(self) -> dict:
        with self._cv:
            avg = (self._batched_requests / self._batches_total
                   if self._batches_total else 0.0)
            return {
                "engine": self.engine_type,
                "engine_type": self.engine_type,
                "requests_total": self._requests_total,
                "batches_total": self._batches_total,
                "avg_batch": round(avg, 3),
                "max_batch": self.max_batch,
                "queue_depth": len(self._queue),
                "in_flight": self._in_flight,
                "uptime_s": self._clock() - self._t0,
                "warmup_s": self._warmup_s,
                "draining": self._draining,
            }


def create_multimodal_engine(engine_name: str, pipeline: Any,
                             engine_args: Optional[dict] = None,
                             log=None) -> BatchImageEngine:
    """Build (not warm or start) the named engine; ``engine_args`` is
    the config's ENGINE block (``max_batch``, ``gather_ms``,
    ``max_queue``)."""
    if engine_name == "embedding":
        raise NotImplementedError(
            f"engine {engine_name!r} is not yet ported (its pipeline, "
            "pipelines/embedding.py, is not)")
    if engine_name != BatchImageEngine.engine_type:
        raise ValueError(
            f"unknown multimodal engine {engine_name!r}; expected "
            f"{BatchImageEngine.engine_type!r}")
    return BatchImageEngine(pipeline, log=log, **(engine_args or {}))
