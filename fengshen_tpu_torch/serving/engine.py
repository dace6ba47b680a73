"""Continuous-batching inference engine: the port of
``fengshen_tpu/serving/engine.py`` (greedy and sampled decode with the
logits controls, and speculative ticks, over slot and paged pools in
the compute dtype or int8).

Many requests share a fixed pool of ``num_slots`` KV lanes:

- admission: a queued prompt is LEFT-padded to a bucket
  (:class:`~.buckets.BucketLadder`), prefilled batch-1 through the
  model's own cache (``utils.generate._prefill_cache``) and copied into
  a free lane (``cache.assign_slot``; an int8 slot pool quantizes it
  in with ``paged_cache.assign_slot_quantized``; a paged pool takes
  ``paged_cache.assign_paged``, which quantizes into an int8 pool);
- decode: every tick runs ONE forward over all ``num_slots`` lanes, each
  at its own cursor; on the card its attention is the decode kernel;
- reclaim: a finished, cancelled or expired lane goes to the next queued
  request at once;
- backpressure: a bounded queue; ``submit`` raises :class:`QueueFull`
  (429 at the API) or :class:`PromptTooLong` (413);
- paged pool: admission charges each request its footprint in blocks,
  and an exhausted pool defers the head of the queue until reclaim;
- sampling (``do_sample``): each lane draws under its own key, from the
  engine's ``seed`` and the request's seed (``submit(seed=...)``, else
  the CRC-32 of its id), at a draw counter that starts at admission and
  advances once per tick; a lane's tokens never depend on which other
  requests share the pool (``utils/rng.py``);
- logits controls (repetition penalty, ``no_repeat_ngram_size`` 1,
  ``min_length``) read a per-lane token history on the device;
- speculative ticks (``spec_mode``): ``"prompt_lookup"`` drafts
  ``spec_gamma`` tokens per lane from its committed history,
  ``"self_draft"`` from the target's own first ``spec_draft_layers``
  layers (``make_self_draft``, over a slot pool of its own in the compute
  dtype); ONE target forward verifies every lane's ``[gamma+1]`` window
  (on the card, K3 at S = gamma+1) and each lane commits its accepted
  prefix plus one token and rolls its cursor back over the rest.

The host holds the authoritative per-lane position, last token and
cursor. The plain tick uploads the cursor every tick; a speculative tick
leaves it on the device, where the verify forward advances it by
gamma+1 and ``rollback_slots`` takes each lane's rejected tail back off,
as the reference's does. Greedy output, speculative or not, is
token-identical to ``utils.generate.generate`` (the tests pin it).

Around the ticks, as in the reference (all host-side bookkeeping
between forwards; greedy tokens are unchanged):

- commit journal: every admitted request stays, by reference, in a
  bounded ring (``journal_ring``); :meth:`partial` snapshots its
  committed tokens (``GET /partial/<id>``), and ``submit(resume_tokens=)``
  resumes a request from them: ONE bucketed prefill of prompt +
  ``resume_tokens[:-1]``, then decode from ``resume_tokens[-1]``;
- streams: ``submit(stream=True)`` opens a live token stream the
  scheduler feeds at commit time; :meth:`attach_stream` reopens it for a
  ``Last-Event-ID`` reconnect (``streaming/``);
- timelines: every request carries a ``RequestTimeline`` (enqueued,
  admitted, prefill, per-tick commits, terminal); the last
  ``debug_ring`` finished ones stay for :meth:`debug_requests` /
  :meth:`debug_request`, and their phases feed
  ``fstpu_request_phase_seconds``;
- flight recorder: with a ``recorder``, the engine's events enter its
  ring and a failed tick dumps a bundle (stats, config, timelines);
- drain: :meth:`begin_drain` refuses new work (``Draining``) and flushes
  the queue, while running lanes finish; an explicit ``request_id``
  that is live already raises ``DuplicateRequest``.

Not yet ported: AOT and live evacuation to peers (``serving/handoff.py``).
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
import zlib
from collections import OrderedDict, deque
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from fengshen_tpu_torch.device import check_module_device
from fengshen_tpu_torch.models.llama.modeling_llama import (KVCache,
                                                            make_self_draft)
from fengshen_tpu_torch.observability import (RequestTimeline,
                                              record_warmup_seconds, span)
from fengshen_tpu_torch.ops.kernels import KernelError, log_dispatch
from fengshen_tpu_torch.serving.buckets import DEFAULT_BUCKETS, BucketLadder
from fengshen_tpu_torch.serving.cache import (assign_slot, init_slot_cache,
                                              reset_free_slots,
                                              rollback_slots)
from fengshen_tpu_torch.serving.metrics import EngineMetrics
from fengshen_tpu_torch.serving.paged_cache import (BlockAllocator,
                                                    assign_paged,
                                                    assign_slot_quantized,
                                                    blocks_for_tokens,
                                                    init_pool_cache)
from fengshen_tpu_torch.streaming import StreamBook
from fengshen_tpu_torch.utils.generate import (
    STREAM_DRAFT, STREAM_ROUND, STREAM_TOKEN, _controls_active,
    _ngram_propose_lanes, _prefill_cache, _select_token, _spec_round_tokens,
    _spec_round_tokens_lanes, apply_logits_controls, position_ids_from_mask)
from fengshen_tpu_torch.utils.rng import Draws, lane_key


class QueueFull(Exception):
    """Admission queue at ``max_queue``: the API layer maps this to 429."""


class PromptTooLong(Exception):
    """Prompt outgrows the bucket ladder or the cache headroom (413)."""


class EngineStopped(RuntimeError):
    """The engine stopped serving after a kernel failure or a failed
    warmup: the API layer maps this to 503, and ``/healthz`` reports the
    replica not ready."""


class Draining(Exception):
    """The engine is draining (:meth:`ContinuousBatchingEngine.begin_drain`):
    in-flight work finishes, new submissions are refused (503 with
    reason "draining" at the API)."""


class DuplicateRequest(Exception):
    """An explicit request_id matching a live (queued or running)
    request: an id never runs twice at once on one replica (409)."""


QUEUED, RUNNING, FINISHED, CANCELLED, EXPIRED, REJECTED = (
    "queued", "running", "finished", "cancelled", "expired", "rejected")


@dataclasses.dataclass
class EngineConfig:
    """Engine knobs (``engine.py:123``), validated as the reference
    validates them (``:205-238``). Every field of the reference's
    dataclass is accepted, so its configs load."""

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
    # "fp32" keeps the pool in the compute dtype; "int8" stores K/V
    # quantized with per-(token, head) absmax scales (~half the bytes)
    kv_dtype: str = "fp32"                   # "fp32" | "int8"
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
            if self.spec_gamma < 1:
                raise ValueError("spec_gamma must be >= 1")
            if self.spec_ngram < 1:
                raise ValueError("spec_ngram must be >= 1")
            if self.spec_mode == "self_draft" and \
                    self.spec_draft_layers < 1:
                raise ValueError("spec_draft_layers must be >= 1")
            if self.do_sample and self.spec_mode == "prompt_lookup":
                # the rejection rule divides by the drafter's proposal
                # distribution; copied tokens come from none
                raise ValueError(
                    "spec_mode='prompt_lookup' is greedy-only "
                    "(do_sample=False): lookup proposals carry no "
                    "draft distribution for the rejection-sampling "
                    "accept rule (use spec_mode='self_draft' for "
                    "sampled speculation)")
            if _controls_active(self.repetition_penalty,
                                self.no_repeat_ngram_size,
                                self.min_length):
                # the processors act at ONE committed cursor; the verify
                # forward scores gamma+1 positions at once
                raise ValueError(
                    "spec_mode cannot run logits controls "
                    "(repetition_penalty / no_repeat_ngram_size / "
                    "min_length act per committed cursor, but the "
                    "verify forward scores gamma+1 positions at once)")


class Request:
    """One in-flight generation; host-side bookkeeping only."""

    _ids = itertools.count()

    def __init__(self, prompt: np.ndarray, max_new_tokens: int,
                 request_id: Optional[str], deadline: Optional[float],
                 submit_time: float, epoch: Optional[float] = None):
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
        #: resume-from-token-k: tokens a previous execution committed
        #: (prefilled with the prompt, never decoded again) and where
        #: they came from
        self.resume: list[int] = []
        self.resume_source: Optional[str] = None
        #: the reference's live-evacuation target; the port does not
        #: evacuate, so it stays None (streams read it)
        self.evac_target: Optional[str] = None
        #: sampling seed (``submit`` resolves it): with the engine's seed
        #: it makes the lane's key at admission
        self.seed: int = 0
        self._cancel = False
        self._done = threading.Event()
        #: lifecycle events, appended on the scheduler thread; ``epoch``
        #: anchors ``submit_time``'s monotonic axis on the wall clock
        self.timeline = RequestTimeline(submit_time, epoch=epoch)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the request leaves the engine; True when it did
        within ``timeout``."""
        return self._done.wait(timeout)

    @property
    def done(self) -> bool:
        return self._done.is_set()


#: the longest the serve loop steps aside between ticks for callers
#: blocked on the engine's lock
YIELD_S = 0.05


class _YieldingLock:
    """The engine's re-entrant lock, counting the threads blocked in
    ``acquire``. A tick holds the lock for its whole forward and the
    serve loop takes it again at once; a plain lock lets that loop win
    the race every time, so ``submit``, ``stats``, ``cancel`` and the
    drain could wait seconds for an idle engine. The loop steps aside
    while :attr:`waiting` is non-zero (``_serve_loop``)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._count = threading.Lock()
        self.waiting = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._lock.acquire(False):
            return True
        if not blocking:
            return False
        with self._count:
            self.waiting += 1
        try:
            return self._lock.acquire(True, timeout)
        finally:
            with self._count:
                self.waiting -= 1

    def release(self) -> None:
        self._lock.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    # what threading.Condition.wait uses on an RLock
    def _release_save(self):
        return self._lock._release_save()

    def _acquire_restore(self, state) -> None:
        self._lock._acquire_restore(state)

    def _is_owned(self) -> bool:
        return self._lock._is_owned()


class ContinuousBatchingEngine:
    """Continuous batching over one LLaMA-family model.

    ``device=None`` means ``cuda``; the model must live on the device.
    ``clock`` (monotonic) and ``wall`` are injectable for deterministic
    deadline and timeline tests. ``recorder`` is an optional
    ``observability.FlightRecorder``."""

    engine_type = "continuous"

    def __init__(self, model, config: EngineConfig, *, device=None,
                 log: Optional[Callable[[dict], None]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 recorder: Any = None,
                 wall: Callable[[], float] = time.time):
        self.device = check_module_device(model, device)
        self.model = model
        self.config = config
        self.ladder = BucketLadder(config.buckets)
        self.metrics = EngineMetrics()
        self._log = log or (lambda entry: None)
        self._clock = clock
        self._wall = wall
        #: the last debug_ring finished (or rejected) request timelines
        self._recent: deque = deque(maxlen=config.debug_ring)
        self._t0_clock = clock()
        self._last_error: Optional[dict] = None
        #: a kernel failure or a failed warmup stops the engine for good
        #: (see _serve_loop and fail)
        self._fatal: Optional[BaseException] = None
        self._fatal_what = ""
        self._recorder = recorder
        if recorder is not None:
            # engine events enter the recorder's ring on their way to
            # the caller's sink; the provider adds stats, config and
            # timelines to every bundle
            self._log = recorder.wrap_sink(self._log)
            recorder.attach("engine", self._debug_bundle)
        log_dispatch(self._log, self.device)
        self.max_len = int(model.config.max_position_embeddings)
        self.paged = config.kv_layout == "paged"
        self.spec = config.spec_mode != "off"
        self.self_draft = config.spec_mode == "self_draft"
        # admission reserves gamma EXTRA positions per lane: the verify
        # forward writes the whole gamma+1 window before the accept
        # counts are known, so a rejected tail lands past the cursor
        # (masked, later overwritten) but must stay inside the lane
        self._gamma = config.spec_gamma if self.spec else 0
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
        if self.ladder.buckets[0] + 1 + self._gamma > self.seq_capacity:
            raise ValueError(
                f"smallest bucket {self.ladder.buckets[0]} leaves no "
                f"decode headroom in the KV lane capacity "
                f"{self.seq_capacity}" + self._gamma_note())
        if self.self_draft:
            # the target's first spec_draft_layers layers with its shared
            # embedding, norm and head (no copy); its pool is a slot pool
            # in the compute dtype with the target lanes' capacity, never
            # paged or int8, so its cursors stay congruent with the
            # target's
            self._draft_model = make_self_draft(model,
                                                config.spec_draft_layers)
            self._draft_model.config = self._draft_model.model.config = \
                dataclasses.replace(self._draft_model.config,
                                    max_position_embeddings=self.seq_capacity)
            self._draft_cache = init_slot_cache(self._draft_model, S)
        cfg = config
        self._control_kw = dict(repetition_penalty=cfg.repetition_penalty,
                                no_repeat_ngram_size=cfg.no_repeat_ngram_size,
                                min_length=cfg.min_length,
                                eos_token_id=cfg.eos_token_id)
        self._controls_on = _controls_active(cfg.repetition_penalty,
                                             cfg.no_repeat_ngram_size,
                                             cfg.min_length)

        self._cache = self._init_pool()
        pool = self._cache
        self._kv_bytes = sum(
            t.numel() * t.element_size() for t in
            pool.keys + pool.values +
            (pool.key_scales + pool.value_scales if pool.quantized else []))
        self._mask = torch.zeros((S, self.seq_capacity), dtype=torch.long,
                                 device=self.device)
        # each lane's tokens by physical position (padded prompt, then
        # committed tokens): the controls' history and the lookup
        # drafter's text
        self._history = torch.zeros_like(self._mask)
        # host-side per-slot state (authoritative for scheduling)
        self._last_tok = np.zeros((S,), np.int64)
        self._pos = np.zeros((S,), np.int64)    # logical position of last_tok
        self._phys = np.zeros((S,), np.int64)   # physical cache cursor
        self._active = np.zeros((S,), bool)
        # sampling: each lane's key (two 32-bit words, installed at
        # admission) and draw counter (0 is the prefill's draw; every
        # tick uses the next, whether or not the lane commits)
        self._keys = np.zeros((S, 2), np.int64)
        self._draw = np.zeros((S,), np.int64)
        self._slot_req: list[Optional[Request]] = [None] * S
        self._queue: deque[Request] = deque()
        # commit journal: request_id -> the live Request, a bounded
        # insertion-ordered ring; entries are references, so committed
        # tokens grow in place at no per-tick cost
        self._journal: "OrderedDict[str, Request]" = OrderedDict()
        #: live SSE token streams, fed at commit time
        self.streams = StreamBook()
        self._draining = False
        self._lock = _YieldingLock()
        self._cv = threading.Condition(self._lock)
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

    def _gamma_note(self) -> str:
        return (f" (speculative window needs gamma={self._gamma} extra "
                "positions)" if self._gamma else "")

    # ---- submission side -------------------------------------------

    def _journal_add_locked(self, req: Request) -> None:
        """Enter ``req`` into the bounded commit journal (``:805``; the
        caller holds ``_cv``). A later request under the same id replaces
        the older entry: the latest execution owns the id."""
        self._journal[req.request_id] = req
        self._journal.move_to_end(req.request_id)
        while len(self._journal) > self.config.journal_ring:
            self._journal.popitem(last=False)

    def _record_rejection_locked(self, req: Request, reason: str,
                                 **attrs) -> None:
        """Mark ``req`` rejected, stamp its terminal timeline event, put
        its waterfall in the debug ring and close its stream (the caller
        holds ``_cv``)."""
        req.state = REJECTED
        req.finish_reason = reason
        req.timeline.add(self._clock(), "rejected", reason=reason, **attrs)
        self._recent.append(self._request_dict(req))
        self._sync_stream(req)

    def _reject_prompt(self, ids: np.ndarray, reason: str,
                       request_id: Optional[str],
                       trace_id: Optional[str] = None,
                       parent_span_id: Optional[str] = None,
                       **attrs) -> None:
        """A 413-class rejection: counted, logged, and its timeline kept
        in the debug ring although the request never queued."""
        self.metrics.count("rejected_prompt_too_long")
        self._log({"event": "serving_reject", "reason": reason,
                   "prompt_tokens": int(len(ids)), **attrs})
        req = Request(ids, 0, request_id, None, self._clock(),
                      epoch=self._wall())
        req.timeline.trace_id = trace_id
        req.timeline.parent_span_id = parent_span_id
        with self._cv:
            self._record_rejection_locked(
                req, reason, prompt_tokens=int(len(ids)), **attrs)

    def _refuse_draining(self) -> None:
        self.metrics.count("rejected_draining")
        self._log({"event": "serving_reject", "reason": "draining"})
        raise Draining("engine is draining; not admitting")

    def submit(self, input_ids, max_new_tokens: Optional[int] = None,
               request_id: Optional[str] = None,
               deadline_s: Optional[float] = None,
               trace_id: Optional[str] = None,
               parent_span_id: Optional[str] = None,
               resume_tokens: Optional[Sequence[int]] = None,
               resume_source: Optional[str] = None,
               seed: Optional[int] = None,
               stream: bool = False) -> Request:
        """Queue a prompt (``:846-1043``). Raises ``QueueFull``
        (backpressure), ``PromptTooLong`` (no bucket or no cache
        headroom), ``Draining`` or ``DuplicateRequest`` (an explicit id
        that is queued or running). ``deadline_s`` is seconds from now;
        an expired request frees its slot and finishes with reason
        "deadline". ``trace_id``/``parent_span_id`` are stamped on the
        request's timeline.

        ``resume_tokens`` are tokens a previous execution of this
        request committed (``GET /partial/<id>``). Admission prefills
        prompt + ``resume_tokens[:-1]`` in ONE bucketed prefill and
        decodes on from ``resume_tokens[-1]``: greedy, the tail is the
        uninterrupted run's. ``max_new_tokens`` keeps its meaning of the
        TOTAL generation (the resumed prefix counts toward it).

        ``seed`` pins the request's sampling stream; None derives it from
        the request id (``:983-988``), so a retry under the same id
        draws the same tokens. ``stream=True`` opens a live token stream
        before any token can commit."""
        if self._fatal is not None:
            raise EngineStopped(self.stopped_reason())
        if self._draining:
            self._refuse_draining()
        if max_new_tokens is not None and int(max_new_tokens) < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        resume = [int(t) for t in resume_tokens] if resume_tokens else []
        requested_new = int(max_new_tokens if max_new_tokens is not None
                            else self.config.max_new_tokens)
        if resume and requested_new <= len(resume):
            raise ValueError(
                f"resume_tokens carries {len(resume)} tokens but "
                f"max_new_tokens={requested_new} leaves nothing to "
                "decode")
        ids = np.asarray(input_ids, np.int32).reshape(-1)
        trace = dict(trace_id=trace_id, parent_span_id=parent_span_id)
        # a resumed request prefills prompt + resume[:-1]; the last
        # committed token re-enters as the decode seed
        carried = max(len(resume) - 1, 0)
        bucket = self.ladder.bucket_for(len(ids) + carried)
        if bucket is None:
            self._reject_prompt(ids, "prompt_too_long", request_id, **trace)
            raise PromptTooLong(
                f"prompt of {len(ids)} tokens exceeds the largest "
                f"bucket {self.ladder.max_bucket}")
        # the lane holds the bucket, the generated tokens and the
        # gamma-wide speculative tail; a resumed request's carried
        # tokens ride inside the bucket, so they give that headroom back
        max_new = min(requested_new,
                      self.seq_capacity - bucket - self._gamma + carried)
        if max_new < (len(resume) + 1 if resume else 1):
            self._reject_prompt(ids, "prompt_too_long", request_id,
                                bucket=int(bucket), **trace)
            raise PromptTooLong(
                f"bucket {bucket} leaves no decode headroom in the KV "
                f"lane capacity {self.seq_capacity}" + self._gamma_note())
        if self.paged:
            # a footprint the whole pool cannot hold would sit at the
            # head of the queue forever: reject it now
            need = blocks_for_tokens(
                bucket + self._decode_span(max_new, resume) + self._gamma,
                self.block_size)
            if need > self._allocator.total_blocks:
                self._reject_prompt(
                    ids, "kv_pool_too_small", request_id,
                    blocks_needed=int(need),
                    blocks_total=int(self._allocator.total_blocks),
                    **trace)
                raise PromptTooLong(
                    f"request needs {need} KV blocks but the pool only "
                    f"has {self._allocator.total_blocks}")
        now = self._clock()
        req = Request(ids, max_new, request_id,
                      None if deadline_s is None else now + deadline_s, now,
                      epoch=self._wall())
        req.timeline.trace_id = trace_id
        req.timeline.parent_span_id = parent_span_id
        req.seed = (int(seed) & 0x7FFFFFFF) if seed is not None \
            else zlib.crc32(req.request_id.encode()) & 0x7FFFFFFF
        if resume:
            # the journal and the debug endpoints show the true progress
            # from the start, and the finish check counts the total
            req.resume = resume
            req.resume_source = resume_source
            req.tokens = list(resume)
        with span("serving/admit"), self._cv:
            # again under the lock: the serve thread sets _fatal and
            # exits holding it, and nothing drains the queue after that
            if self._fatal is not None:
                raise EngineStopped(self.stopped_reason())
            if self._draining:
                self._refuse_draining()
            if request_id is not None:
                for live in self._live_requests_locked():
                    if live.request_id == request_id:
                        self.metrics.count("rejected_duplicate")
                        self._log({"event": "serving_reject",
                                   "reason": "duplicate_request_id",
                                   "request_id": request_id,
                                   "live_state": live.state})
                        raise DuplicateRequest(
                            f"request_id {request_id!r} is already "
                            f"{live.state} on this replica")
            if len(self._queue) >= self.config.max_queue:
                self.metrics.count("rejected_queue_full")
                self._log({"event": "serving_reject",
                           "reason": "queue_full",
                           "queue_depth": len(self._queue)})
                self._record_rejection_locked(
                    req, "queue_full", queue_depth=len(self._queue))
                raise QueueFull(
                    f"admission queue at max_queue="
                    f"{self.config.max_queue}")
            self._queue.append(req)
            req.timeline.add(now, "enqueued", prompt_tokens=int(len(ids)),
                             bucket=bucket, queue_depth=len(self._queue))
            if resume:
                req.timeline.add(now, "resumed_from", tokens=len(resume),
                                 source=resume_source)
            self._journal_add_locked(req)
            if stream:
                # open() replays req.tokens, so a resumed stream starts
                # at k, not 0
                self.streams.open(req)
            self.metrics.count("admitted")
            self._log({"event": "serving_admit",
                       "request_id": req.request_id, "bucket": bucket,
                       "queue_depth": len(self._queue)})
            self._cv.notify_all()
        return req

    @staticmethod
    def _decode_span(max_new: int, resume: list) -> int:
        """Tokens a lane DECODES past its prefill bucket (what a paged
        lane is charged for): a resumed request's carried prefix lives
        inside the bucket."""
        return max_new - len(resume) + 1 if resume else max_new

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
        if self.spec:
            return self._spec_step(active_idx)
        t0 = time.perf_counter()
        with span("serving/decode"):
            nxt = self._decode_tick()
        self._draw += 1
        dt = time.perf_counter() - t0
        self.metrics.record_tick(len(active_idx), self.config.num_slots, dt)
        self._last_tok = nxt
        self._pos[self._active] += 1
        self._phys[self._active] += 1
        t_commit = self._clock()
        for i in active_idx:
            req = self._slot_req[i]
            tok = int(nxt[i])
            req.tokens.append(tok)
            req.timeline.add(t_commit, "commit", n=1, tick_s=round(dt, 6))
            self._sync_stream(req)
            if self.config.eos_token_id is not None and \
                    tok == self.config.eos_token_id:
                self._release(i, FINISHED, "eos")
            elif len(req.tokens) >= req.max_new_tokens:
                self._release(i, FINISHED, "length")
        return int(self._active.sum())

    def _spec_step(self, active_idx: np.ndarray) -> int:
        """One speculative tick and its commit: each lane takes its
        accepted prefix plus the correction (1..gamma+1 tokens), cut at
        eos or its max_new; the cursors advance by what was committed
        (``engine.py:1075-1135``)."""
        cfg = self.config
        t0 = time.perf_counter()
        with span("serving/decode"):
            n_r, win = self._spec_tick()
        self._draw += 1
        dt = time.perf_counter() - t0
        commit = np.where(self._active, n_r + 1, 0)
        last = win[np.arange(win.shape[0]), np.maximum(commit - 1, 0)]
        self._last_tok = np.where(self._active, last, cfg.pad_token_id)
        self._pos += commit
        self._phys += commit
        # metrics count DELIVERED tokens: a lane that finishes inside
        # its window drops the tail
        delivered = accepted = 0
        t_commit = self._clock()
        for i in active_idx:
            req = self._slot_req[i]
            k, fin = 0, None
            for tok in (int(t) for t in win[i, :commit[i]]):
                req.tokens.append(tok)
                k += 1
                if cfg.eos_token_id is not None and \
                        tok == cfg.eos_token_id:
                    fin = "eos"
                    break
                if len(req.tokens) >= req.max_new_tokens:
                    fin = "length"
                    break
            # the commit event precedes a release: _finish snapshots
            # the timeline into the debug ring
            req.timeline.add(t_commit, "commit", n=k,
                             accepted=min(int(n_r[i]), k),
                             tick_s=round(dt, 6))
            self._sync_stream(req)
            if fin is not None:
                self._release(i, FINISHED, fin)
            delivered += k
            # tokens at offsets < n_r are accepted drafts, the one at
            # n_r the correction
            accepted += min(int(n_r[i]), k)
        self.metrics.record_tick(len(active_idx), cfg.num_slots, dt,
                                 tokens=delivered)
        self.metrics.record_spec(cfg.spec_gamma * len(active_idx), accepted)
        return int(self._active.sum())

    def _tick_draws(self) -> Draws:
        """Every lane's key at its current draw counter (copies: the host
        arrays move on after the tick)."""
        return Draws(torch.tensor(self._keys, device=self.device),
                     torch.tensor(self._draw, device=self.device))

    def _select(self, logits: torch.Tensor,
                draws: Optional[Draws]) -> torch.Tensor:
        cfg = self.config
        return _select_token(logits, draws, cfg.do_sample, cfg.temperature,
                             cfg.top_k, cfg.top_p)

    @torch.no_grad()
    def _decode_tick(self) -> np.ndarray:
        """One forward of every lane's last token at its own cursor.
        Inactive lanes are parked (cursor 0, null block) and their
        output is the pad token. Returns the next tokens on the host."""
        dev = self.device
        active = torch.from_numpy(self._active).to(dev)
        phys = torch.from_numpy(self._phys).to(dev)
        tokens = torch.from_numpy(self._last_tok).to(dev)
        self._cache.index = phys
        reset_free_slots(self._cache, active)
        # the token chosen last tick joins the history at its cursor,
        # where the forward writes its K/V
        self._history[torch.arange(len(tokens), device=dev), phys] = tokens
        logits = self.model(
            tokens[:, None], attention_mask=self._mask,
            position_ids=torch.from_numpy(self._pos).to(dev)[:, None],
            cache=self._cache)
        step_logits = logits[:, -1]
        if self._controls_on:
            step_logits = apply_logits_controls(
                step_logits, self._history, (phys + 1)[:, None],
                history_mask=self._mask, **self._control_kw)
        draws = self._tick_draws().sub(STREAM_TOKEN) \
            if self.config.do_sample else None
        nxt = torch.where(active, self._select(step_logits, draws),
                          self.config.pad_token_id)
        return nxt.cpu().numpy()

    @torch.no_grad()
    def _spec_tick(self):
        """Draft ``gamma`` tokens per lane, verify every lane's window
        ``[last, d_1..d_gamma]`` in ONE target forward, and take each
        lane's accept counts ``n_r`` and window tokens ``win`` (padded
        after the commit) to the host. ``prompt_lookup`` drafts from the
        lane's history (``engine.py:634-690``); ``self_draft`` runs
        gamma+1 batched draft steps over its own pool (``:538-632``).
        Both pools advance gamma+1 in the forward and roll back
        gamma - n_r per lane together."""
        cfg = self.config
        dev = self.device
        gamma = cfg.spec_gamma
        active = torch.from_numpy(self._active).to(dev)
        phys = torch.from_numpy(self._phys).to(dev)
        pos = torch.from_numpy(self._pos).to(dev)
        tokens = torch.from_numpy(self._last_tok).to(dev)
        lanes = torch.arange(len(tokens), device=dev)
        steps = torch.arange(gamma + 1, device=dev)[None]
        if self.paged:
            # park reclaimed lanes on the null block BEFORE the forward:
            # their blocks may already belong to another lane
            reset_free_slots(self._cache, active)
        self._history[lanes, phys] = tokens
        tick = self._tick_draws() if cfg.do_sample else None
        if self.self_draft:
            reset_free_slots(self._draft_cache, active)
            cur, props, d_steps = tokens, [], []
            for i in range(gamma + 1):
                # the first step writes the committed token's draft K/V;
                # the last proposal is never verified, but its forward
                # writes the K/V the next tick would need
                step = self._draft_model(
                    cur[:, None], attention_mask=self._mask,
                    position_ids=(pos + i)[:, None],
                    cache=self._draft_cache)[:, -1]
                cur = self._select(step, None if tick is None else
                                   tick.sub(STREAM_DRAFT).sub(i))
                props.append(cur)
                d_steps.append(step)
            drafts = torch.stack(props[:gamma], dim=1)
            d_logits = torch.stack(d_steps[:gamma], dim=1) \
                if cfg.do_sample else None
        else:
            drafts = _ngram_propose_lanes(self._history, phys + 1,
                                          cfg.spec_ngram, gamma, tokens)
        verify = torch.cat([tokens[:, None], drafts], dim=1)
        logits = self.model(verify, attention_mask=self._mask,
                            position_ids=pos[:, None] + steps,
                            cache=self._cache)
        if self.self_draft:
            n_r, w = _spec_round_tokens_lanes(
                logits, d_logits, drafts,
                None if tick is None else tick.sub(STREAM_ROUND),
                do_sample=cfg.do_sample, temperature=cfg.temperature,
                top_k=cfg.top_k, top_p=cfg.top_p)
        else:
            n_r, w = _spec_round_tokens(logits, None, drafts, None,
                                        do_sample=False)
        n_r = torch.where(active, n_r, 0)
        delta = torch.where(active, gamma - n_r, 0)
        rollback_slots(self._cache, delta)
        if self.self_draft:
            rollback_slots(self._draft_cache, delta)
        if not self.paged:
            reset_free_slots(self._cache, active)
        win = torch.where(steps < (n_r + 1)[:, None], w,
                          cfg.pad_token_id)
        win = torch.where(active[:, None], win, cfg.pad_token_id)
        # the committed window joins the history after the cursor, for
        # the next tick's drafter (the slot past it holds pad)
        self._history[lanes[:, None], phys[:, None] + 1 + steps] = win
        return n_r.cpu().numpy(), win.cpu().numpy()

    @torch.no_grad()
    def _prefill(self, row: np.ndarray, mask_row: np.ndarray,
                 key=(0, 0)):
        """Batch-1 prefill of a bucket-padded prompt; returns the first
        token (the controls applied, drawn under the lane ``key`` at
        counter 0 when sampling) and the primed lockstep cache."""
        ids = torch.from_numpy(row).to(self.device).long()[None]
        mask = torch.from_numpy(mask_row).to(self.device).long()[None]
        logits, primed = _prefill_cache(self.model, ids, mask,
                                        position_ids_from_mask(mask))
        step_logits = logits[:, -1]
        if self._controls_on:
            step_logits = apply_logits_controls(
                step_logits, ids, ids.shape[1], history_mask=mask,
                **self._control_kw)
        draws = Draws(torch.tensor([key], device=self.device),
                      torch.zeros(1, dtype=torch.long, device=self.device)
                      ).sub(STREAM_TOKEN) if self.config.do_sample else None
        return int(self._select(step_logits, draws)[0]), primed

    def _draft_primed(self, primed: KVCache) -> KVCache:
        """The draft tower's primed lane: its layers are the target's
        first layers, so their prompt K/V are the target prefill's
        (before any quantization), cut to the draft pool's lanes."""
        n, L = self.config.spec_draft_layers, self.seq_capacity
        return KVCache([k[:, :L] for k in primed.keys[:n]],
                       [v[:, :L] for v in primed.values[:n]], primed.index)

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
            # resume-from-token-k: the committed prefix minus its last
            # token joins the prompt in ONE bucketed prefill (the same
            # left-pad positions as the incremental decode that made it)
            resume = req.resume
            prefill_ids = req.prompt if not resume else np.concatenate(
                [req.prompt, np.asarray(resume[:-1], np.int32)])
            bucket = self.ladder.bucket_for(len(prefill_ids))
            blocks = None
            if self.paged:
                # admission needs enough free blocks for the request's
                # footprint; when the pool can't serve it, the head of
                # the queue waits for reclaim (FIFO)
                need = blocks_for_tokens(
                    bucket + self._decode_span(req.max_new_tokens, resume)
                    + self._gamma, self.block_size)
                blocks = self._allocator.alloc(need)
                if blocks is None:
                    self._queue.appendleft(req)
                    if self._deferred_req != req.request_id:
                        self._deferred_req = req.request_id
                        self.metrics.count("deferred_admissions")
                        req.timeline.add(
                            now, "deferred", blocks_needed=int(need),
                            blocks_free=int(self._allocator.free_blocks))
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
                    prefill_ids, bucket, self.config.pad_token_id)
                key = lane_key(self.config.seed, req.seed)
                req.timeline.add(self._clock(), "admitted", slot=slot,
                                 bucket=int(bucket))
                req.timeline.add(self._clock(), "prefill_start",
                                 bucket=int(bucket))
                with span("serving/prefill"):
                    tok, primed = self._prefill(row, mask_row, key)
                self.metrics.record_prefill(bucket)
                t_first = self._clock()
                req.ttft_s = t_first - req.submit_time
                self.metrics.record_ttft(req.ttft_s)
                req.timeline.add(t_first, "first_token")
                if resume:
                    # the prefill's token is dropped: a resumed lane's
                    # next decode seed is the committed resume[-1]
                    tok = resume[-1]
                else:
                    req.tokens.append(tok)
                self._sync_stream(req)
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
                if self.self_draft:
                    assign_slot(self._draft_cache,
                                self._draft_primed(primed), slot)
                if self.paged:
                    assign_paged(self._cache, primed, slot, blocks)
                elif self._cache.quantized:
                    assign_slot_quantized(self._cache, primed, slot)
                else:
                    assign_slot(self._cache, primed, slot)
                # mask lane: the padded prompt, open from the bucket edge
                # on (causal validity bounds the open tail); history
                # lane: the padded prompt
                self._mask[slot] = 1
                self._mask[slot, :bucket] = torch.from_numpy(
                    mask_row).to(self.device)
                self._history[slot] = 0
                self._history[slot, :bucket] = torch.from_numpy(
                    row).to(self.device)
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
            # logical position of last_tok: prompt + committed - 1 (a
            # fresh lane holds one token, a resumed one k)
            self._pos[slot] = len(req.prompt) + len(req.tokens) - 1
            self._phys[slot] = bucket           # physical cursor
            self._keys[slot] = key
            # token j of a request is drawn at counter j (the prefill's
            # at 0), so a resumed lane draws on where it stopped
            self._draw[slot] = len(req.tokens)

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
        end_t = self._clock()
        req.timeline.add(end_t, state, reason=reason)
        phases = req.timeline.phases(end_t)
        self.metrics.record_phases(phases)
        self._recent.append(self._request_dict(req, phases=phases))
        self.metrics.record_latency(end_t - req.submit_time)
        self._log({"event": "serving_finish",
                   "request_id": req.request_id, "reason": reason,
                   "tokens": len(req.tokens), "ttft_s": req.ttft_s})
        # the terminal sync delivers any tail tokens and closes the stream
        self._sync_stream(req)
        req._done.set()

    def _sync_stream(self, req: Request) -> None:
        """Push ``req``'s committed tokens to its live stream, if one is
        open (one dict probe when none is)."""
        n = self.streams.sync(req)
        if n:
            self.metrics.record_stream_tokens(n)

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
                        self._fatal_what = "a kernel failure"
                    self._reset_pool_locked()
                self._dump("engine_tick_error",
                           {"error_type": type(e).__name__})
                if self._fatal is not None:
                    return
                n = 0
            if self._recorder is not None:
                # rate-limited inside: the bundle carries recent metric
                # trajectories, not only the final values
                self._recorder.snapshot_metrics((self.metrics.registry,))
            if n == 0:
                with self._cv:
                    if not self._queue and not self._stop_flag:
                        self._cv.wait(timeout=0.02)
            # callers blocked on the lock during the tick take it before
            # the next one (bounded, so a stream of callers cannot stall
            # the decode)
            yield_until = time.monotonic() + YIELD_S
            while self._lock.waiting and time.monotonic() < yield_until:
                time.sleep(1e-4)

    def _dump(self, reason: str, extra: dict) -> None:
        """Write a flight-recorder bundle, if a recorder is attached;
        its failure is logged, never raised."""
        if self._recorder is None:
            return
        try:
            self._recorder.snapshot_metrics((self.metrics.registry,),
                                            force=True)
            self._recorder.dump(reason=reason, extra=extra)
        except Exception as err:  # noqa: BLE001 - telemetry only
            self._log({"event": "flightrec_dump_error",
                       "error": str(err)[:200]})

    def fail(self, error: BaseException, what: str) -> None:
        """Stop the engine for good with ``error`` (``what`` happened,
        e.g. "a failed warmup"): queued work fails, later submissions
        raise ``EngineStopped``, and :meth:`stopped_reason` says why."""
        with self._cv:
            self._fatal = error
            self._fatal_what = what
            self._last_error = {"type": type(error).__name__,
                                "at": self._clock()}
            self._reset_pool_locked()
            self._cv.notify_all()
        self._dump("engine_stopped", {"error_type": type(error).__name__,
                                      "what": what})

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
        if self.self_draft:
            self._draft_cache = init_slot_cache(self._draft_model,
                                                self.config.num_slots)
        self._mask.zero_()
        self._history.zero_()
        self._keys[:] = 0
        self._draw[:] = 0
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

    # ---- drain ---------------------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> None:
        """Refuse new work (``submit`` raises ``Draining``) and flush the
        queued-but-unstarted requests back to their callers as
        rejections with reason "draining" (503 at the API). Running
        lanes keep decoding to their end (``:1536``)."""
        with self._cv:
            if self._draining:
                return
            self._draining = True
            flushed = list(self._queue)
            self._queue.clear()
            for req in flushed:
                self._record_rejection_locked(req, "draining")
                req._done.set()
            self._log({"event": "serving_drain",
                       "queued_flushed": len(flushed),
                       "active": int(self._active.sum())})
            self._cv.notify_all()

    def idle(self) -> bool:
        """True when nothing is queued or decoding (the drain's exit
        condition)."""
        with self._cv:
            return not self._queue and not bool(self._active.any())

    def live_lane_ids(self) -> list:
        """Request ids of every RUNNING lane."""
        with self._cv:
            return [r.request_id for r in self._slot_req
                    if r is not None and r.state == RUNNING]

    # ---- commit journal and streams -------------------------------------

    def partial(self, request_id: str) -> Optional[dict]:
        """``GET /partial/<id>`` (``:1579``): the journal's snapshot of
        one request's committed tokens; None when the id never ran here
        or aged out of the ring."""
        with self._cv:
            req = self._journal.get(request_id)
            if req is None:
                return None
            out = {"request_id": req.request_id,
                   "state": req.state,
                   "finish_reason": req.finish_reason,
                   "prompt_tokens": int(len(req.prompt)),
                   "generated_tokens": len(req.tokens),
                   "tokens": [int(t) for t in req.tokens],
                   "max_new_tokens": int(req.max_new_tokens),
                   "ttft_s": (None if req.ttft_s is None
                              else round(req.ttft_s, 6)),
                   "trace_id": req.timeline.trace_id}
            if req.evac_target is not None:
                out["evac_target"] = req.evac_target
            if req.resume:
                out["resumed_tokens"] = len(req.resume)
                out["resume_source"] = req.resume_source
            return out

    def attach_stream(self, request_id: str):
        """(Re)open the live token stream of a journaled request, the
        ``Last-Event-ID`` reconnect path (``:1606``): an open stream is
        returned as is; a finished request's stream replays its tokens
        and closes. None when the id is not in the journal."""
        with self._cv:
            req = self._journal.get(request_id)
            if req is None:
                return None
            return self.streams.open(req)

    # ---- warmup and observability -------------------------------------

    def warmup(self) -> float:
        """Run one prefill per bucket and one decode (or speculative)
        tick before traffic, so the first user pays neither the kernel
        build nor the libraries' first-call setup. Returns seconds. With
        every lane free the tick only writes where nothing is read (lane
        positions from 0, the null block). A failure raises; the server
        then stops the engine (:meth:`fail`) instead of serving."""
        t0 = time.perf_counter()
        with self._cv:
            for bucket in self.ladder.buckets:
                if bucket + 1 + self._gamma > self.seq_capacity:
                    continue
                self._prefill(np.ones((bucket,), np.int32),
                              np.ones((bucket,), np.int32))
            if self.spec:
                self._spec_tick()
            else:
                self._decode_tick()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.metrics.warmup_compile_s = round(dt, 3)
        record_warmup_seconds("engine", dt)
        self._log({"event": "serving_warmup", "seconds": round(dt, 3),
                   "buckets": list(self.ladder.buckets),
                   "num_slots": self.config.num_slots})
        return dt

    def _kv_stats_locked(self) -> dict:
        """KV-pool utilization; the slot layout reports lanes as
        max_len-token blocks so the two layouts read on one scale;
        fragmentation is the unwritten fraction of allocated lane
        capacity."""
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
        frag = round(1.0 - used_tokens / alloc_tokens, 4) \
            if alloc_tokens else 0.0
        return {"layout": cfg.kv_layout, "dtype": cfg.kv_dtype,
                "blocks_total": total, "blocks_used": used,
                "blocks_free": total - used, "block_tokens": block_tokens,
                "bytes": self._kv_bytes, "fragmentation": frag}

    def stopped_reason(self) -> Optional[str]:
        """Why the engine stopped serving for good (a kernel failure or
        a failed warmup), or None while it serves."""
        if self._fatal is None:
            return None
        return (f"engine stopped after {self._fatal_what}: "
                f"{type(self._fatal).__name__}: {self._fatal}")

    def stats(self) -> dict:
        """The ``/stats`` payload: the reference's keys (``:1738``) plus
        ``decode_seconds`` and ``device``."""
        with self._cv:
            now = self._clock()
            last_error = None
            if self._last_error is not None:
                last_error = {
                    "type": self._last_error["type"],
                    "age_s": round(now - self._last_error["at"], 3)}
            return dict(self.metrics.snapshot(
                queue_depth=len(self._queue),
                slots_active=int(self._active.sum()),
                num_slots=self.config.num_slots,
                kv=self._kv_stats_locked(),
                spec=({"mode": self.config.spec_mode,
                       "gamma": self.config.spec_gamma}
                      if self.spec else None),
                streams=({"active": self.streams.active()}
                         if self.streams.ever_opened else None),
                uptime_s=now - self._t0_clock, last_error=last_error,
                draining=self._draining),
                engine_type=self.engine_type, device=str(self.device))

    # ---- debug introspection ------------------------------------------

    def _request_dict(self, req: Request,
                      phases: Optional[dict] = None) -> dict:
        """The full waterfall of one request, live or finished (callers
        hold ``_cv``)."""
        if phases is None:
            phases = req.timeline.phases(self._clock())
        d = {"request_id": req.request_id,
             "state": req.state,
             "finish_reason": req.finish_reason,
             "prompt_tokens": int(len(req.prompt)),
             "generated_tokens": len(req.tokens),
             "max_new_tokens": int(req.max_new_tokens),
             "slot": req.slot,
             "ttft_s": (None if req.ttft_s is None
                        else round(req.ttft_s, 6)),
             "phases": phases}
        d.update(req.timeline.to_dict())
        return d

    @staticmethod
    def _request_summary(d: dict) -> dict:
        """The list-endpoint row: the waterfall minus its event log."""
        return {k: d[k] for k in
                ("request_id", "state", "finish_reason",
                 "prompt_tokens", "generated_tokens", "slot",
                 "ttft_s", "phases", "trace_id")}

    def _live_requests_locked(self) -> list:
        return list(self._queue) + [r for r in self._slot_req
                                    if r is not None]

    def debug_requests(self) -> dict:
        """``GET /debug/requests`` (``:1824``): summaries of every queued
        and running request and of the ring of recently finished (or
        rejected) ones, newest last."""
        with self._cv:
            in_flight = [self._request_summary(self._request_dict(r))
                         for r in self._live_requests_locked()]
            recent = [self._request_summary(d) for d in self._recent]
        return {"in_flight": in_flight, "recent": recent,
                "debug_ring": self.config.debug_ring}

    def debug_request(self, request_id: str) -> Optional[dict]:
        """``GET /debug/requests/<id>`` (``:1835``): the full event
        timeline and waterfall; None when the id is neither live nor in
        the ring."""
        with self._cv:
            for req in self._live_requests_locked():
                if req.request_id == request_id:
                    return self._request_dict(req)
            for d in reversed(self._recent):
                if d["request_id"] == request_id:
                    return d
        return None

    def _debug_bundle(self) -> dict:
        """The flight-recorder provider: stats, configs and every live
        and recent request's timeline."""
        with self._cv:
            requests = [self._request_dict(r)
                        for r in self._live_requests_locked()]
            requests += list(self._recent)
        return {"stats": self.stats(),
                "engine_config": repr(self.config),
                "model_config": repr(self.model.config),
                "requests": requests}
