"""Token-by-token delivery for the continuous-batching engine (the
port's copy of ``fengshen_tpu/streaming``, stdlib only): ``stream``
holds the per-request token feeds the scheduler fills at commit time,
``sse`` the Server-Sent-Events framing (event id = token index)."""

from fengshen_tpu_torch.streaming.sse import format_event, iter_sse
from fengshen_tpu_torch.streaming.stream import StreamBook, TokenStream

__all__ = ["StreamBook", "TokenStream", "format_event", "iter_sse"]
