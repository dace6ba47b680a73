from fengshen_tpu_torch.serving.buckets import DEFAULT_BUCKETS, BucketLadder
from fengshen_tpu_torch.serving.cache import (assign_slot, init_slot_cache,
                                              reset_free_slots,
                                              rollback_slots)
from fengshen_tpu_torch.serving.engine import (
    CANCELLED, EXPIRED, FINISHED, QUEUED, REJECTED, RUNNING,
    ContinuousBatchingEngine, Draining, DuplicateRequest, EngineConfig,
    EngineStopped, PromptTooLong, QueueFull, Request)
from fengshen_tpu_torch.serving.multimodal import (BatchImageEngine,
                                                   MMRequest,
                                                   create_multimodal_engine)
from fengshen_tpu_torch.serving.paged_cache import (BlockAllocator,
                                                    assign_paged,
                                                    assign_slot_quantized,
                                                    blocks_for_tokens,
                                                    init_pool_cache)

__all__ = ["DEFAULT_BUCKETS", "BucketLadder", "assign_slot",
           "init_slot_cache", "reset_free_slots", "rollback_slots",
           "CANCELLED", "EXPIRED", "FINISHED", "QUEUED", "REJECTED", "RUNNING",
           "ContinuousBatchingEngine", "Draining", "DuplicateRequest",
           "EngineConfig", "EngineStopped",
           "PromptTooLong", "QueueFull", "Request", "BlockAllocator", "assign_paged",
           "assign_slot_quantized", "blocks_for_tokens", "init_pool_cache",
           "BatchImageEngine", "MMRequest", "create_multimodal_engine"]
