"""Continuous-batching inference engine: the port of
``fengshen_tpu/serving/engine.py`` (greedy decode over slot and paged
pools in the compute dtype).

Many requests share a fixed pool of ``num_slots`` KV lanes:

- admission: a queued prompt is LEFT-padded to a bucket
  (:class:`~.buckets.BucketLadder`), prefilled batch-1 through the
  model's own cache (``utils.generate._prefill_cache``) and copied into
  a free lane (``cache.assign_slot`` / ``paged_cache.assign_paged``);
- decode: every tick runs ONE forward over all ``num_slots`` lanes, each
  at its own cursor; on the card its attention is the decode kernel;
- reclaim: a finished, cancelled or expired lane goes to the next queued
  request at once;
- backpressure: a bounded queue; ``submit`` raises :class:`QueueFull`
  (429 at the API) or :class:`PromptTooLong` (413);
- paged pool: admission charges each request its footprint in blocks,
  and an exhausted pool defers the head of the queue until reclaim.

The host holds the authoritative per-lane state (cursor, position, last
token) and uploads it every tick, so the pool needs no device-side
bookkeeping between ticks. Greedy output is token-identical to
``utils.generate.generate`` (the tests pin it).

Not yet ported from the reference: sampling, logits controls,
speculative ticks, int8 KV, the commit journal, streams, timelines,
the flight recorder, AOT, drain and evacuation. Options that ask for
them raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from fengshen_tpu_torch.device import check_module_device
from fengshen_tpu_torch.ops.kernels import KernelError, log_dispatch
from fengshen_tpu_torch.serving.buckets import DEFAULT_BUCKETS, BucketLadder
from fengshen_tpu_torch.serving.cache import assign_slot, reset_free_slots
from fengshen_tpu_torch.serving.metrics import EngineMetrics
from fengshen_tpu_torch.serving.paged_cache import (BlockAllocator,
                                                    assign_paged,
                                                    blocks_for_tokens,
                                                    init_pool_cache)
from fengshen_tpu_torch.utils.generate import (_prefill_cache,
                                               _select_token,
                                               position_ids_from_mask)


class QueueFull(Exception):
    """Admission queue at ``max_queue``: the API layer maps this to 429."""


class PromptTooLong(Exception):
    """Prompt outgrows the bucket ladder or the cache headroom (413)."""


class EngineStopped(RuntimeError):
    """The engine stopped serving after a kernel failure: the API layer
    maps this to 503, and ``/healthz`` reports the replica not ready."""


QUEUED, RUNNING, FINISHED, CANCELLED, EXPIRED, REJECTED = (
    "queued", "running", "finished", "cancelled", "expired", "rejected")

_NOT_PORTED = "not yet ported"


@dataclasses.dataclass
class EngineConfig:
    """Engine knobs (``engine.py:123``). Every field of the reference's
    dataclass is accepted, so its configs load; the sampling,
    logits-control, speculative and debug-ring options raise
    ``NotImplementedError`` for anything but their defaults."""

    num_slots: int = 8
    buckets: Sequence[int] = DEFAULT_BUCKETS
    max_new_tokens: int = 128
    max_queue: int = 64
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 0.0
    repetition_penalty: float = 1.0
    no_repeat_ngram_size: int = 0
    min_length: int = 0
    seed: int = 0
    kv_layout: str = "slot"                  # "slot" | "paged"
    kv_dtype: str = "fp32"                   # unquantized pool
    kv_block_size: int = 64                  # tokens per paged block
    kv_num_blocks: Optional[int] = None      # default: slot-parity + null
    kv_max_blocks_per_slot: Optional[int] = None  # default: max_len/bs
    spec_mode: str = "off"
    spec_gamma: int = 4                      # drafted tokens per tick
    spec_ngram: int = 2                      # suffix length to match
    spec_draft_layers: int = 2               # self-draft tower depth
    debug_ring: int = 64                     # finished-request timelines
    journal_ring: int = 256                  # commit-journal entries

    def __post_init__(self):
        if self.num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if self.debug_ring < 1:
            raise ValueError("debug_ring must be >= 1")
        if self.journal_ring < 1:
            raise ValueError("journal_ring must be >= 1")
        if self.kv_layout not in ("slot", "paged"):
            raise ValueError(f"unknown kv_layout {self.kv_layout!r}; "
                             "expected 'slot' or 'paged'")
        if self.kv_dtype not in ("fp32", "int8"):
            raise ValueError(f"unknown kv_dtype {self.kv_dtype!r}; "
                             "expected 'fp32' or 'int8'")
        if self.kv_layout == "paged" and self.kv_block_size < 1:
            raise ValueError("kv_block_size must be >= 1")
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if self.no_repeat_ngram_size > 1:
            raise ValueError(
                "the continuous engine supports no_repeat_ngram_size of "
                "0 or 1 only (per-slot cursors cannot drive the n>1 "
                "window processor)")
        if self.spec_mode not in ("off", "prompt_lookup", "self_draft"):
            raise ValueError(
                f"unknown spec_mode {self.spec_mode!r}; expected 'off', "
                "'prompt_lookup' or 'self_draft'")
        if self.spec_mode != "off":
            raise NotImplementedError(
                f"spec_mode={self.spec_mode!r}: {_NOT_PORTED}")
        for name in ("spec_gamma", "spec_ngram", "spec_draft_layers",
                     "debug_ring", "journal_ring"):
            default = type(self).__dataclass_fields__[name].default
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} (default {default!r}): "
                    f"{_NOT_PORTED}")
        if self.kv_dtype == "int8":
            raise NotImplementedError(f"kv_dtype='int8': {_NOT_PORTED}")
        if self.do_sample:
            raise NotImplementedError(f"do_sample=True: {_NOT_PORTED}")
        if (self.repetition_penalty != 1.0 or self.no_repeat_ngram_size
                or self.min_length):
            raise NotImplementedError(
                f"logits controls (repetition_penalty / "
                f"no_repeat_ngram_size / min_length): {_NOT_PORTED}")


class Request:
    """One in-flight generation; host-side bookkeeping only."""

    _ids = itertools.count()

    def __init__(self, prompt: np.ndarray, max_new_tokens: int,
                 request_id: Optional[str], deadline: Optional[float],
                 submit_time: float):
        self.request_id = request_id if request_id is not None else \
            f"req-{next(Request._ids)}"
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.deadline = deadline            # engine-clock absolute time
        self.submit_time = submit_time
        self.state = QUEUED
        self.tokens: list[int] = []         # generated tokens (eos incl.)
        self.ttft_s: Optional[float] = None
        self.finish_reason: Optional[str] = None
        self.slot: Optional[int] = None
        self._cancel = False
        self._done = threading.Event()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the request leaves the engine; True when it did
        within ``timeout``."""
        return self._done.wait(timeout)

    @property
    def done(self) -> bool:
        return self._done.is_set()


class ContinuousBatchingEngine:
    """Continuous batching over one LLaMA-family model.

    ``device=None`` means ``cuda``; the model must live on the device.
    ``clock`` is injectable for deterministic deadline tests."""

    engine_type = "continuous"

    def __init__(self, model, config: EngineConfig, *, device=None,
                 log: Optional[Callable[[dict], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.device = check_module_device(model, device)
        self.model = model
        self.config = config
        self.ladder = BucketLadder(config.buckets)
        self.metrics = EngineMetrics()
        self._log = log or (lambda entry: None)
        self._clock = clock
        self._t0_clock = clock()
        self._last_error: Optional[dict] = None
        #: a kernel failure stops the engine for good (see _serve_loop)
        self._fatal: Optional[BaseException] = None
        log_dispatch(self._log, self.device)
        self.max_len = int(model.config.max_position_embeddings)
        self.paged = config.kv_layout == "paged"
        S = config.num_slots
        if self.paged:
            bs = int(config.kv_block_size)
            if bs > self.max_len:
                raise ValueError(
                    f"kv_block_size {bs} exceeds "
                    f"max_position_embeddings={self.max_len}")
            mb = int(self.max_len // bs
                     if config.kv_max_blocks_per_slot is None
                     else config.kv_max_blocks_per_slot)
            if mb < 1 or mb * bs > self.max_len:
                raise ValueError(
                    f"kv_max_blocks_per_slot={mb} x kv_block_size={bs} "
                    f"must fit in 1..max_position_embeddings="
                    f"{self.max_len}")
            nb = int(S * mb + 1 if config.kv_num_blocks is None
                     else config.kv_num_blocks)
            self.block_size, self.max_blocks_per_slot = bs, mb
            self.num_blocks = nb
            # the lane's logical extent bounds prompt + decode
            self.seq_capacity = mb * bs
            self._allocator = BlockAllocator(nb)
            self._slot_blocks: list[list[int]] = [[] for _ in range(S)]
            self._deferred_req: Optional[str] = None
        else:
            self.seq_capacity = self.max_len
        if self.ladder.buckets[0] + 1 > self.seq_capacity:
            raise ValueError(
                f"smallest bucket {self.ladder.buckets[0]} leaves no "
                f"decode headroom in the KV lane capacity "
                f"{self.seq_capacity}")

        self._cache = self._init_pool()
        self._kv_bytes = sum(t.numel() * t.element_size()
                             for t in self._cache.keys + self._cache.values)
        self._mask = torch.zeros((S, self.seq_capacity), dtype=torch.long,
                                 device=self.device)
        # host-side per-slot state (authoritative for scheduling)
        self._last_tok = np.zeros((S,), np.int64)
        self._pos = np.zeros((S,), np.int64)    # logical position of last_tok
        self._phys = np.zeros((S,), np.int64)   # physical cache cursor
        self._active = np.zeros((S,), bool)
        self._slot_req: list[Optional[Request]] = [None] * S
        self._queue: deque[Request] = deque()
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stop_flag = False

    def _init_pool(self):
        cfg = self.config
        if self.paged:
            return init_pool_cache(
                self.model, cfg.num_slots, layout="paged",
                kv_dtype=cfg.kv_dtype, num_blocks=self.num_blocks,
                block_size=self.block_size,
                max_blocks_per_slot=self.max_blocks_per_slot)
        return init_pool_cache(self.model, cfg.num_slots, layout="slot",
                               kv_dtype=cfg.kv_dtype)

    # ---- submission side -------------------------------------------

    def _reject(self, reason: str, ids: np.ndarray, **attrs) -> None:
        self.metrics.count("rejected_prompt_too_long")
        self._log({"event": "serving_reject", "reason": reason,
                   "prompt_tokens": int(len(ids)), **attrs})

    def submit(self, input_ids, max_new_tokens: Optional[int] = None,
               request_id: Optional[str] = None,
               deadline_s: Optional[float] = None) -> Request:
        """Queue a prompt. Raises QueueFull (backpressure) or
        PromptTooLong (no bucket or no cache headroom). ``deadline_s`` is
        seconds from now; an expired request frees its slot and finishes
        with reason "deadline"."""
        if self._fatal is not None:
            raise EngineStopped(self.stopped_reason())
        if max_new_tokens is not None and int(max_new_tokens) < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        requested_new = int(max_new_tokens if max_new_tokens is not None
                            else self.config.max_new_tokens)
        ids = np.asarray(input_ids, np.int32).reshape(-1)
        bucket = self.ladder.bucket_for(len(ids))
        if bucket is None:
            self._reject("prompt_too_long", ids)
            raise PromptTooLong(
                f"prompt of {len(ids)} tokens exceeds the largest "
                f"bucket {self.ladder.max_bucket}")
        max_new = min(requested_new, self.seq_capacity - bucket)
        if max_new < 1:
            self._reject("prompt_too_long", ids, bucket=int(bucket))
            raise PromptTooLong(
                f"bucket {bucket} leaves no decode headroom in the KV "
                f"lane capacity {self.seq_capacity}")
        if self.paged:
            # a footprint the whole pool cannot hold would sit at the
            # head of the queue forever: reject it now
            need = blocks_for_tokens(bucket + max_new, self.block_size)
            if need > self._allocator.total_blocks:
                self._reject("kv_pool_too_small", ids, blocks_needed=need)
                raise PromptTooLong(
                    f"request needs {need} KV blocks but the pool only "
                    f"has {self._allocator.total_blocks}")
        now = self._clock()
        req = Request(ids, max_new, request_id,
                      None if deadline_s is None else now + deadline_s, now)
        with self._cv:
            # again under the lock: the serve thread sets _fatal and
            # exits holding it, and nothing drains the queue after that
            if self._fatal is not None:
                raise EngineStopped(self.stopped_reason())
            if len(self._queue) >= self.config.max_queue:
                self.metrics.count("rejected_queue_full")
                self._log({"event": "serving_reject",
                           "reason": "queue_full",
                           "queue_depth": len(self._queue)})
                req.state, req.finish_reason = REJECTED, "queue_full"
                raise QueueFull(
                    f"admission queue at max_queue="
                    f"{self.config.max_queue}")
            self._queue.append(req)
            self.metrics.count("admitted")
            self._log({"event": "serving_admit",
                       "request_id": req.request_id, "bucket": bucket,
                       "queue_depth": len(self._queue)})
            self._cv.notify_all()
        return req

    def cancel(self, request_id: str) -> bool:
        """Cancel a queued or running request; a running one frees its
        slot at the next tick. False when the id is unknown or done."""
        with self._cv:
            for req in self._queue:
                if req.request_id == request_id:
                    self._queue.remove(req)
                    self._finish(req, CANCELLED, "cancelled")
                    return True
            for req in self._slot_req:
                if req is not None and req.request_id == request_id:
                    req._cancel = True
                    return True
        return False

    # ---- engine loop -----------------------------------------------

    def step(self) -> int:
        """One tick: reclaim -> admit -> one decode forward over the pool.
        Returns the number of lanes still active after the tick."""
        with self._cv:
            return self._step_locked()

    def _step_locked(self) -> int:
        now = self._clock()
        expired = [r for r in self._queue
                   if r.deadline is not None and now > r.deadline]
        for req in expired:
            self._queue.remove(req)
            self._finish(req, EXPIRED, "deadline")
        for i, req in enumerate(self._slot_req):
            if req is None:
                continue
            if req._cancel:
                self._release(i, CANCELLED, "cancelled")
            elif req.deadline is not None and now > req.deadline:
                self._release(i, EXPIRED, "deadline")
        self._admit()
        active_idx = np.nonzero(self._active)[0]
        if len(active_idx) == 0:
            return 0
        t0 = time.perf_counter()
        nxt = self._decode_tick()
        self.metrics.record_tick(len(active_idx), self.config.num_slots,
                                 time.perf_counter() - t0)
        self._last_tok = nxt
        self._pos[self._active] += 1
        self._phys[self._active] += 1
        for i in active_idx:
            req = self._slot_req[i]
            tok = int(nxt[i])
            req.tokens.append(tok)
            if self.config.eos_token_id is not None and \
                    tok == self.config.eos_token_id:
                self._release(i, FINISHED, "eos")
            elif len(req.tokens) >= req.max_new_tokens:
                self._release(i, FINISHED, "length")
        return int(self._active.sum())

    @torch.no_grad()
    def _decode_tick(self) -> np.ndarray:
        """One forward of every lane's last token at its own cursor.
        Inactive lanes are parked (cursor 0, null block) and their
        output is the pad token. Returns the next tokens on the host."""
        dev = self.device
        active = torch.from_numpy(self._active).to(dev)
        self._cache.index = torch.from_numpy(self._phys).to(dev)
        reset_free_slots(self._cache, active)
        logits = self.model(
            torch.from_numpy(self._last_tok).to(dev)[:, None],
            attention_mask=self._mask,
            position_ids=torch.from_numpy(self._pos).to(dev)[:, None],
            cache=self._cache)
        nxt = torch.where(active, _select_token(logits[:, -1]),
                          self.config.pad_token_id)
        return nxt.cpu().numpy()

    @torch.no_grad()
    def _prefill(self, row: np.ndarray, mask_row: np.ndarray):
        """Batch-1 prefill of a bucket-padded prompt; returns the first
        token and the primed lockstep cache."""
        ids = torch.from_numpy(row).to(self.device).long()[None]
        mask = torch.from_numpy(mask_row).to(self.device).long()[None]
        logits, primed = _prefill_cache(self.model, ids, mask,
                                        position_ids_from_mask(mask))
        return int(_select_token(logits[:, -1])[0]), primed

    def _admit(self) -> None:
        for slot in range(self.config.num_slots):
            if self._active[slot] or not self._queue:
                continue
            req = self._queue.popleft()
            now = self._clock()
            if req._cancel:
                self._finish(req, CANCELLED, "cancelled")
                continue
            if req.deadline is not None and now > req.deadline:
                self._finish(req, EXPIRED, "deadline")
                continue
            bucket = self.ladder.bucket_for(len(req.prompt))
            blocks = None
            if self.paged:
                # admission needs enough free blocks for the request's
                # footprint; when the pool can't serve it, the head of
                # the queue waits for reclaim (FIFO)
                need = blocks_for_tokens(bucket + req.max_new_tokens,
                                         self.block_size)
                blocks = self._allocator.alloc(need)
                if blocks is None:
                    self._queue.appendleft(req)
                    if self._deferred_req != req.request_id:
                        self._deferred_req = req.request_id
                        self.metrics.count("deferred_admissions")
                        self._log({"event": "serving_defer",
                                   "reason": "kv_blocks_exhausted",
                                   "request_id": req.request_id,
                                   "blocks_needed": need,
                                   "blocks_free":
                                       self._allocator.free_blocks})
                    return
                self._deferred_req = None
            try:
                row, mask_row = self.ladder.pad_prompt(
                    req.prompt, bucket, self.config.pad_token_id)
                tok, primed = self._prefill(row, mask_row)
                self.metrics.record_prefill(bucket)
                req.ttft_s = self._clock() - req.submit_time
                self.metrics.record_ttft(req.ttft_s)
                req.tokens.append(tok)
                done = None
                if self.config.eos_token_id is not None and \
                        tok == self.config.eos_token_id:
                    done = "eos"
                elif len(req.tokens) >= req.max_new_tokens:
                    done = "length"
                if done is not None:
                    if blocks is not None:
                        self._allocator.free(blocks)
                    self._finish(req, FINISHED, done)
                    continue
                if self.paged:
                    assign_paged(self._cache, primed, slot, blocks)
                else:
                    assign_slot(self._cache, primed, slot)
                # mask lane: the padded prompt, open from the bucket edge
                # on (causal validity bounds the open tail)
                self._mask[slot] = 1
                self._mask[slot, :bucket] = torch.from_numpy(
                    mask_row).to(self.device)
            except BaseException:
                # the popped request must not hang and its blocks must
                # go back to the pool before the error propagates
                if blocks is not None:
                    self._allocator.free(blocks)
                self._finish(req, EXPIRED, "engine_error")
                raise
            if self.paged:
                self._slot_blocks[slot] = blocks
            req.state = RUNNING
            req.slot = slot
            self._slot_req[slot] = req
            self._active[slot] = True
            self._last_tok[slot] = tok
            self._pos[slot] = len(req.prompt)   # logical pos of last_tok
            self._phys[slot] = bucket           # physical cursor

    def _release(self, slot: int, state: str, reason: str) -> None:
        req = self._slot_req[slot]
        self._slot_req[slot] = None
        self._active[slot] = False
        self._phys[slot] = 0
        self._pos[slot] = 0
        if self.paged and self._slot_blocks[slot]:
            # blocks return to the free list now; the lane's table row
            # is parked on the null block before the next forward
            self._allocator.free(self._slot_blocks[slot])
            self._slot_blocks[slot] = []
        self._finish(req, state, reason)

    def _finish(self, req: Request, state: str, reason: str) -> None:
        req.state = state
        req.finish_reason = reason
        req.slot = None
        self.metrics.count({FINISHED: "completed", CANCELLED: "cancelled",
                            EXPIRED: "expired"}[state])
        self.metrics.record_latency(self._clock() - req.submit_time)
        self._log({"event": "serving_finish",
                   "request_id": req.request_id, "reason": reason,
                   "tokens": len(req.tokens), "ttft_s": req.ttft_s})
        req._done.set()

    # ---- running the engine -----------------------------------------

    def run_until_idle(self, max_ticks: int = 1_000_000) -> None:
        """Tick until queue and pool are empty (offline use)."""
        for _ in range(max_ticks):
            with self._cv:
                if not self._queue and not self._active.any():
                    return
                self._step_locked()
        raise RuntimeError(f"engine still busy after {max_ticks} ticks")

    def generate_all(self, prompts,
                     max_new_tokens: Optional[int] = None) -> list:
        """Submit every prompt, drain, return per-prompt token lists."""
        reqs = [self.submit(p, max_new_tokens) for p in prompts]
        self.run_until_idle()
        return [r.tokens for r in reqs]

    def start(self) -> None:
        """Serve in a daemon thread (the API layer's mode)."""
        if self._thread is not None:
            return
        self._stop_flag = False
        self._thread = threading.Thread(target=self._serve_loop,
                                        daemon=True, name="fstpu-engine")
        self._thread.start()

    def _serve_loop(self) -> None:
        while not self._stop_flag:
            try:
                n = self.step()
            except Exception as e:  # noqa: BLE001 - fail the work, loudly
                # a dead serve thread would leave every waiter blocked
                # for its full timeout: fail the in-flight work now
                self._log({"event": "serving_tick_error",
                           "error": str(e)[:500]})
                with self._cv:
                    self._last_error = {"type": type(e).__name__,
                                        "at": self._clock()}
                    if isinstance(e, KernelError):
                        # a kernel that failed to build or launch does
                        # not get better: stop serving instead of failing
                        # every later request the same way (set before
                        # the in-flight work fails, so a retry that
                        # follows its 503 finds the engine stopped)
                        self._fatal = e
                    self._reset_pool_locked()
                    if self._fatal is not None:
                        return
                n = 0
            if n == 0:
                with self._cv:
                    if not self._queue and not self._stop_flag:
                        self._cv.wait(timeout=0.02)

    def _reset_pool_locked(self) -> None:
        """Fail every queued/running request and rebuild the pool."""
        for req in list(self._queue):
            self._queue.remove(req)
            self._finish(req, EXPIRED, "engine_error")
        for i, req in enumerate(self._slot_req):
            if req is not None:
                self._release(i, EXPIRED, "engine_error")
        if self.paged:
            self._allocator = BlockAllocator(self.num_blocks)
            self._slot_blocks = [[] for _ in range(self.config.num_slots)]
            self._deferred_req = None
        self._cache = self._init_pool()
        self._mask.zero_()
        self._last_tok[:] = 0
        self._pos[:] = 0
        self._phys[:] = 0
        self._active[:] = False

    def stop(self) -> None:
        self._stop_flag = True
        with self._cv:
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def warmup(self) -> float:
        """Run one prefill per bucket and one decode tick before traffic,
        so the first user pays neither the kernel build nor the
        libraries' first-call setup. Returns seconds. With every lane
        free the tick only writes where nothing is read (lane position 0,
        the null block)."""
        t0 = time.perf_counter()
        with self._cv:
            for bucket in self.ladder.buckets:
                if bucket + 1 > self.seq_capacity:
                    continue
                self._prefill(np.ones((bucket,), np.int32),
                              np.ones((bucket,), np.int32))
            self._decode_tick()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.metrics.warmup_s = dt
        self._log({"event": "serving_warmup", "seconds": dt,
                   "buckets": list(self.ladder.buckets),
                   "num_slots": self.config.num_slots})
        return dt

    # ---- observability ----------------------------------------------

    def _kv_stats_locked(self) -> dict:
        """KV-pool utilization; the slot layout reports lanes as
        max_len-token blocks so the two layouts read on one scale."""
        cfg = self.config
        used_tokens = int(self._phys[self._active].sum())
        if self.paged:
            total = self._allocator.total_blocks
            used = self._allocator.used_blocks
            block_tokens = self.block_size
            alloc_tokens = sum(len(b) for b in self._slot_blocks) * \
                block_tokens
        else:
            total = cfg.num_slots
            used = int(self._active.sum())
            block_tokens = self.max_len
            alloc_tokens = used * block_tokens
        return {
            "kv_layout": cfg.kv_layout, "kv_dtype": cfg.kv_dtype,
            "kv_blocks_total": total, "kv_blocks_used": used,
            "kv_blocks_free": total - used, "kv_block_tokens": block_tokens,
            "kv_cache_bytes": self._kv_bytes,
            "kv_fragmentation": (1.0 - used_tokens / alloc_tokens
                                 if alloc_tokens else 0.0)}

    def stopped_reason(self) -> Optional[str]:
        """Why the engine stopped serving for good (a kernel failure), or
        None while it serves."""
        if self._fatal is None:
            return None
        return (f"engine stopped after a kernel failure: "
                f"{type(self._fatal).__name__}: {self._fatal}")

    def stats(self) -> dict:
        with self._cv:
            now = self._clock()
            last_error = None
            if self._last_error is not None:
                last_error = {"type": self._last_error["type"],
                              "age_s": now - self._last_error["at"]}
            return self.metrics.snapshot(
                queue_depth=len(self._queue),
                slots_active=int(self._active.sum()),
                num_slots=self.config.num_slots,
                uptime_s=now - self._t0_clock, last_error=last_error,
                device=str(self.device), engine_type=self.engine_type,
                **self._kv_stats_locked())
