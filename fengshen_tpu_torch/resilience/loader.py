"""ResilientLoader: bounded retry around a train or validation loader.
The port's copy of ``fengshen_tpu/resilience/loader.py``.

After a failure the wrapper re-enters the wrapped loader
(``iter(loader)``). Loaders on the stateful resumable sampler (the
train loader: ``PretrainingRandomSampler`` advertises
``resumes_mid_epoch``) resume mid-epoch; every other loader is
fast-forwarded past the batches already delivered, so a retry never
re-yields an earlier batch. ``resumable`` overrides the detection.

Per failure: retry up to ``max_retries`` times with exponential backoff
(``backoff_base * 2**attempt``) and deterministic jitter; then spend one
unit of the per-epoch ``skip_batch_budget`` (resumable loaders only),
advancing past the poison batch through the cooperative ``skip_next()``
(``DataLoader`` pulls one batch of indices from its sampler without
fetching); with the budget spent, re-raise.

``retries_total`` and ``skipped_total`` count, ``loader_retry`` and
``loader_skip_batch`` events go to ``log``, and the registry's
``fstpu_loader_*`` counters mirror them for ``/metrics``. The Trainer
reads ``skipped_total`` as each batch is fetched, to credit skipped
samples to ``consumed_samples`` when training passes them.
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Optional

from fengshen_tpu_torch.observability import get_registry


class ResilientLoader:
    def __init__(self, loader: Any, max_retries: int = 3,
                 backoff_base: float = 0.5, skip_batch_budget: int = 0,
                 log: Optional[Callable[[dict], None]] = None,
                 stage: str = "train",
                 sleep: Callable[[float], None] = time.sleep,
                 jitter_seed: int = 0,
                 resumable: Optional[bool] = None):
        self.loader = loader
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.skip_batch_budget = int(skip_batch_budget)
        self._log = log or (lambda entry: None)
        self.stage = stage
        self._sleep = sleep
        self._jitter = random.Random(jitter_seed)
        self.retries_total = 0
        #: cumulative skipped batches — the trainer snapshots this at
        #: fetch time (see _prefetch) to fold skipped stream positions
        #: into consumed_samples exactly at the training frontier
        self.skipped_total = 0
        reg = get_registry()
        self._c_retries = reg.counter(
            "fstpu_loader_retries_total",
            "loader read retries", labelnames=("stage",))
        self._c_skipped = reg.counter(
            "fstpu_loader_skipped_batches_total",
            "poison batches skipped after retries exhausted",
            labelnames=("stage",))
        if resumable is None:
            # stateful samplers advertise mid-epoch resume; anything
            # else is assumed deterministic-from-iter() and gets the
            # fast-forward treatment after a re-entry
            resumable = bool(getattr(getattr(loader, "sampler", None),
                                     "resumes_mid_epoch", False))
        self.resumable = bool(resumable)

    # -- passthrough surface (len / peek / num_samples / ...) ----------
    def __getattr__(self, name: str):
        return getattr(self.loader, name)

    def __len__(self) -> int:
        return len(self.loader)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    # -- iteration -----------------------------------------------------
    def __iter__(self):
        skipped_this_epoch = 0
        yielded = 0  # batches delivered downstream this epoch
        fast_forward = 0  # batches to discard after a re-entry
        it = iter(self.loader)
        while True:
            attempt = 0
            while True:
                try:
                    while fast_forward:
                        next(it)
                        fast_forward -= 1
                    batch = next(it)
                    break
                except StopIteration:
                    return
                except Exception as e:  # noqa: BLE001 — bounded retry;
                    # re-raised below once retries + skip budget exhaust
                    attempt += 1
                    self.retries_total += 1
                    self._c_retries.labels(self.stage).inc()
                    if attempt > self.max_retries:
                        if self.resumable and \
                                skipped_this_epoch < self.skip_batch_budget:
                            skipped_this_epoch += 1
                            self.skipped_total += 1
                            self._c_skipped.labels(self.stage).inc()
                            self._log({"event": "loader_skip_batch",
                                       "stage": self.stage,
                                       "skipped_this_epoch":
                                           skipped_this_epoch,
                                       "error": repr(e)[:200]})
                            it = self._reenter(yielded, skip=True)
                            attempt = 0
                            continue
                        raise
                    delay = self.backoff_base * (2 ** (attempt - 1))
                    delay *= 1.0 + 0.25 * self._jitter.random()
                    self._log({"event": "loader_retry",
                               "stage": self.stage, "attempt": attempt,
                               "delay_s": round(delay, 4),
                               "error": repr(e)[:200]})
                    self._sleep(delay)
                    it = self._reenter(yielded)
                    fast_forward = 0 if self.resumable else yielded
            yielded += 1
            yield batch

    def _reenter(self, yielded: int, skip: bool = False):
        """A generator that raised is dead: re-enter the loader.
        Resumable samplers continue mid-epoch on their own; for a skip,
        cooperative loaders advance past the poison batch via
        `skip_next()`."""
        if skip:
            skip_fn = getattr(self.loader, "skip_next", None)
            if callable(skip_fn):
                skip_fn()
        return iter(self.loader)
