"""Continuous-batching serving over a paged KV cache (the port of
``apex_tpu/serve``): the engine, scheduler, paged cache and sampling;
speculative decoding (:mod:`~apex_tpu_torch.serve.spec`); and the
disaggregated fleet, prefill and decode on separate slices behind one
KV-shipping router (:mod:`~apex_tpu_torch.serve.transfer`,
:mod:`~apex_tpu_torch.serve.router`)."""

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
from apex_tpu_torch.serve.router import (
    DecodeReplica,
    DisaggRouter,
    PrefillWorker,
    RouterConfig,
)
from apex_tpu_torch.serve.sampling import advance_key, sample_tokens
from apex_tpu_torch.serve.scheduler import (
    Request,
    SlotScheduler,
    validate_request,
)
from apex_tpu_torch.serve.spec import SpecConfig, SpecEngine, truncated_draft
from apex_tpu_torch.serve.transfer import (
    FleetSlices,
    KVShipment,
    ship,
    slice_fleet,
)

__all__ = ["BlockAllocator", "DecodeReplica", "DisaggRouter",
           "FleetSlices", "KVShipment", "PoolExhausted", "PrefillWorker",
           "Request", "RouterConfig", "ServeConfig", "ServeEngine",
           "SlotScheduler", "SpecConfig", "SpecEngine", "TRASH_BLOCK",
           "advance_key", "chunk_prefill_math", "gather_slot_kv",
           "gather_slot_scales", "make_pools", "make_scale_pools",
           "paged_attention", "sample_tokens", "ship", "slice_fleet",
           "token_write_coords", "truncated_draft", "validate_request"]
