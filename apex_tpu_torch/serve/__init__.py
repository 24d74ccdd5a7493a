"""Continuous-batching serving over a paged KV cache (the port of
``apex_tpu/serve``'s engine, scheduler, paged cache and sampling)."""

from apex_tpu_torch.serve.engine import (
    ServeConfig,
    ServeEngine,
    chunk_prefill_math,
)
from apex_tpu_torch.serve.paged import (
    TRASH_BLOCK,
    BlockAllocator,
    PoolExhausted,
    gather_slot_kv,
    gather_slot_scales,
    make_pools,
    make_scale_pools,
    paged_attention,
    token_write_coords,
)
from apex_tpu_torch.serve.sampling import advance_key, sample_tokens
from apex_tpu_torch.serve.scheduler import (
    Request,
    SlotScheduler,
    validate_request,
)

__all__ = ["BlockAllocator", "PoolExhausted", "Request", "ServeConfig",
           "ServeEngine", "SlotScheduler", "TRASH_BLOCK", "advance_key",
           "chunk_prefill_math", "gather_slot_kv", "gather_slot_scales",
           "make_pools", "make_scale_pools", "paged_attention",
           "sample_tokens", "token_write_coords", "validate_request"]
