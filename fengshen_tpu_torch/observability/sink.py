"""JsonlSink: the one structured-event writer. The port's copy of
``fengshen_tpu/observability/sink.py``.

A callable ``sink(entry: dict)`` that appends one JSON line to a jsonl
``path`` and, with ``echo``, prints the Trainer's console line
(``key=value``, floats at ``.4g``) after ``echo_prefix``. Writes run
under a lock (the exporter thread and the loop may log at once). The
reference's stream target, size rotation, logger bridge and multihost
gating have no caller in the one-process port and are not copied.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional


class JsonlSink:
    """Callable structured-event sink: ``sink({"event": ..., ...})``."""

    def __init__(self, path: Optional[str] = None, echo: bool = False,
                 echo_prefix: str = "[fengshen-tpu-torch] "):
        self.path = path
        self.echo = echo
        self.echo_prefix = echo_prefix
        self._lock = threading.Lock()

    @staticmethod
    def format_echo(entry: dict) -> str:
        """The Trainer's console line format (floats at .4g)."""
        return " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in entry.items())

    def __call__(self, entry: dict) -> None:
        line = json.dumps(entry)
        if self.path is not None:
            with self._lock:
                parent = os.path.dirname(self.path)
                if parent:
                    os.makedirs(parent, exist_ok=True)
                with open(self.path, "a") as f:
                    f.write(line + "\n")
        if self.echo:
            print(f"{self.echo_prefix}{self.format_echo(entry)}",
                  flush=True)
