from fengshen_tpu_torch.serving.buckets import DEFAULT_BUCKETS, BucketLadder
from fengshen_tpu_torch.serving.cache import (assign_slot, init_slot_cache,
                                              reset_free_slots)
from fengshen_tpu_torch.serving.engine import (
    CANCELLED, EXPIRED, FINISHED, QUEUED, REJECTED, RUNNING,
    ContinuousBatchingEngine, EngineConfig, EngineStopped, PromptTooLong,
    QueueFull, Request)
from fengshen_tpu_torch.serving.paged_cache import (BlockAllocator,
                                                    assign_paged,
                                                    blocks_for_tokens,
                                                    init_pool_cache)

__all__ = ["DEFAULT_BUCKETS", "BucketLadder", "assign_slot",
           "init_slot_cache", "reset_free_slots", "CANCELLED", "EXPIRED",
           "FINISHED", "QUEUED", "REJECTED", "RUNNING",
           "ContinuousBatchingEngine", "EngineConfig", "EngineStopped",
           "PromptTooLong", "QueueFull", "Request", "BlockAllocator", "assign_paged",
           "blocks_for_tokens", "init_pool_cache"]
