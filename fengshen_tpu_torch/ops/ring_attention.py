"""Ring attention: the one-device part of
``fengshen_tpu/ops/ring_attention.py``.

:func:`sequence_sharded_call` (:110) is the shared plumbing of the
context-parallel bodies (ring, Ulysses). With no mesh, or a mesh whose
``sequence`` axis is 1, the reference falls back to plain flash
attention (:125-133), and so does the port: that is kernel K1 on a card.
A sequence axis above 1 is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

SEQUENCE_AXIS = "sequence"


def sequence_degree(mesh) -> int:
    """The ``sequence`` axis of ``mesh`` (anything with a ``shape``
    mapping of axis names to sizes), 1 without a mesh."""
    if mesh is None:
        return 1
    return int(dict(mesh.shape).get(SEQUENCE_AXIS, 1))


def sequence_sharded_call(body_fn: Optional[Callable], q: torch.Tensor,
                          k: torch.Tensor, v: torch.Tensor,
                          segment_ids: Optional[torch.Tensor] = None,
                          mesh=None, causal: bool = True) -> torch.Tensor:
    """Run ``body_fn`` over the sequence shards of ``mesh``; on one
    device (no mesh, or a sequence axis of 1) this is flash attention
    over the whole sequence, which ``body_fn`` never sees."""
    degree = sequence_degree(mesh)
    if degree > 1:
        raise NotImplementedError(
            f"context parallelism over a sequence axis of {degree} is not "
            "yet ported (ROADMAP.md queue 1 item 9: parallelism)")
    from fengshen_tpu_torch.ops.flash_attention import flash_attention
    return flash_attention(q, k, v, causal=causal, segment_ids=segment_ids)
