"""Continuous-batching scheduler: fixed decode slots, iteration-level
admission and retirement, block accounting, preempt-and-recompute
eviction, and the prefix-cache hooks — ``apex_tpu/serve/scheduler.py``
with the same policy and the same numpy slot tables.

- **admission**: FIFO; a request enters a free slot when the allocator
  covers its whole worst-case footprint (``ceil((prompt + max_new) /
  block_size)`` blocks) up front, so no running request dies for blocks;
- **eviction**: when a slot is free but blocks are short, the
  youngest-admitted active request is preempted (recompute on resume):
  its blocks return to the pool and a continuation — original prompt
  plus every token generated so far, the remaining budget and the
  slot's saved generator state — joins the back of the queue.  The
  oldest active request is never evicted, and a continuation never
  evicts anyone (total evictions are bounded by fresh submissions);
- **retirement**: a slot retires when its budget is spent or its
  ``eos_id`` appears; its blocks free at once.

With ``prefix_cache=True`` admission probes the allocator's prefix index
over the prompt's full aligned blocks: matched blocks map into the new
slot by incref and are never prefilled; a full-prompt match forks its
last block copy-on-write (the first token needs the last prompt token's
forward pass, whose KV write must land in a private block); retirement
and preemption decref.  Sharing is exact: equal chain hashes mean equal
token histories and so equal KV.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from apex_tpu_torch.obs import metrics as obs_metrics
from apex_tpu_torch.serve.paged import (
    TRASH_BLOCK,
    BlockAllocator,
    PoolExhausted,
    chain_seed,
    chain_step,
    prefix_block_hashes,
)


@dataclasses.dataclass
class Request:
    """One generation request.  ``temperature=0`` is greedy;
    ``top_k<=0`` / ``top_p>=1`` disable those cutoffs; ``seed`` seeds
    the slot's random generator (per request — reproducible regardless
    of batch-mates)."""

    uid: str
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    eos_id: Optional[int] = None
    #: preemption internals: tokens generated before the last
    #: preemption (already part of ``prompt`` for recompute), and the
    #: state of the slot's generator when preempted (``torch.Generator.
    #: get_state()`` as uint8; the stream resumes from it)
    prior_tokens: Tuple[int, ...] = ()
    resume_key: Optional[np.ndarray] = None


def validate_request(req: Request, block_size: int,
                     max_blocks_per_slot: int, num_blocks: int) -> None:
    """Reject a request that can NEVER run on a pool of these shapes
    (empty prompt / zero budget, context over the per-slot page-table
    reach, footprint over the whole usable pool) — at submission, not
    deadlocked later."""
    if len(req.prompt) < 1 or req.max_new_tokens < 1:
        raise ValueError(
            f"{req.uid}: need a non-empty prompt and "
            f"max_new_tokens >= 1")
    total = len(req.prompt) + req.max_new_tokens
    max_context = max_blocks_per_slot * block_size
    if total > max_context:
        raise ValueError(
            f"{req.uid}: prompt+max_new = {total} exceeds the "
            f"per-slot context {max_context} "
            f"({max_blocks_per_slot} blocks x {block_size})")
    need = -(-total // block_size)
    if need > num_blocks - 1:
        raise ValueError(
            f"{req.uid}: needs {need} blocks, pool has "
            f"{num_blocks - 1} usable")


@dataclasses.dataclass
class _Slot:
    request: Request
    blocks: List[int]
    emitted: List[int]
    admit_seq: int
    #: prefix-cache state: tokens covered by shared (or forked) blocks
    #: — the engine starts prefill at the first unmatched token
    prefix_len: int = 0
    #: copy-on-write source: the registered block whose content the
    #: engine copies into this slot's private block at row
    #: ``prefix_len // block_size - 1`` before the full-match
    #: last-token re-dispatch; held (increfed) until ``finish_cow``
    cow_src: Optional[int] = None
    #: incremental chain-hash cursor for registration: the hash after
    #: ``hashed_blocks`` full blocks of this slot's token history
    chain_hash: bytes = b""
    hashed_blocks: int = 0


class SlotScheduler:
    """Host-side slot/queue/block bookkeeping for the serve engine (see
    the module docstring for the policy).  Owns the fixed-shape numpy
    tables the decode step reads; the engine owns the device pools and
    the per-slot generators and executes the admissions/evictions this
    class plans."""

    def __init__(self, num_slots: int, num_blocks: int, block_size: int,
                 max_blocks_per_slot: int,
                 registry: Optional[obs_metrics.Registry] = None,
                 prefix_cache: bool = False):
        if num_slots < 1:
            raise ValueError(f"num_slots={num_slots}")
        self.num_slots = num_slots
        self.block_size = block_size
        self.max_blocks_per_slot = max_blocks_per_slot
        self.max_context = max_blocks_per_slot * block_size
        self.allocator = BlockAllocator(num_blocks)
        #: cross-request prefix sharing (see module docstring); the
        #: probe/hit counts feed the serve_prefix_hit_rate gauge
        self.prefix_cache = prefix_cache
        self.prefix_probes = 0
        self.prefix_hits = 0
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[_Slot]] = [None] * num_slots
        self._admit_seq = 0
        # the fixed-shape tables the decode step reads every step
        self.page_table = np.full((num_slots, max_blocks_per_slot),
                                  TRASH_BLOCK, np.int32)
        self.lengths = np.zeros(num_slots, np.int32)
        self.last_tok = np.zeros(num_slots, np.int32)
        self.active = np.zeros(num_slots, bool)
        self.temperature = np.zeros(num_slots, np.float32)
        self.top_k = np.zeros(num_slots, np.int32)
        self.top_p = np.ones(num_slots, np.float32)
        # -- telemetry (apex_tpu_torch.obs): every count below is a
        # host-side update at a step boundary.  A continuation counts as
        # an admission again (admissions = submissions + preemptions).
        reg = registry if registry is not None else obs_metrics.DEFAULT
        self.metrics = reg
        self._m_admit = reg.counter(
            "serve_admissions_total", "requests installed into a slot "
            "(continuation re-admissions included)")
        self._m_retire = reg.counter(
            "serve_retirements_total", "requests finished and freed")
        self._m_preempt = reg.counter(
            "serve_preemptions_total",
            "evictions (recompute-on-resume continuations queued)")
        self._m_queue = reg.gauge("serve_queue_depth",
                                  "requests waiting for a slot")
        self._m_occ = reg.gauge("serve_slot_occupancy",
                                "active slots / num_slots")
        self._m_blocks = reg.gauge(
            "serve_block_utilization",
            "live KV blocks / usable pool (trash block excluded)")
        self._m_hit_rate = self._m_shared = None
        if prefix_cache:
            self._m_hit_rate = reg.gauge(
                "serve_prefix_hit_rate",
                "admissions whose prompt matched >=1 full cached "
                "block / admissions probed (cumulative; host "
                "bookkeeping at admission time)")
            self._m_shared = reg.gauge(
                "serve_prefix_shared_blocks",
                "physical blocks currently mapped by more than one "
                "slot (refcount > 1)")
        self._update_gauges()

    def _update_gauges(self) -> None:
        self._m_queue.set(float(len(self.queue)))
        self._m_occ.set(self.n_active() / self.num_slots)
        usable = max(self.allocator.num_blocks - 1, 1)
        self._m_blocks.set(self.allocator.live_count / usable)
        if self._m_hit_rate is not None:
            self._m_hit_rate.set(
                self.prefix_hits / self.prefix_probes
                if self.prefix_probes else 0.0)
            self._m_shared.set(float(self.allocator.shared_count))

    # -- queue side ----------------------------------------------------

    def blocks_needed(self, req: Request) -> int:
        total = len(req.prompt) + req.max_new_tokens
        return -(-total // self.block_size)

    def submit(self, req: Request) -> None:
        """Validate (:func:`validate_request`) and enqueue — requests
        that can NEVER run are rejected here, not deadlocked later."""
        validate_request(req, self.block_size, self.max_blocks_per_slot,
                         self.allocator.num_blocks)
        self.queue.append(req)
        self._m_queue.set(float(len(self.queue)))

    # -- step-boundary planning ---------------------------------------

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def n_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def plan(self):
        """The next step-boundary action, or ``None`` to just decode:
        ``("admit", slot, request)`` (blocks already allocated, tables
        set — the engine runs the prefill) or ``("evict", slot)`` (the
        engine saves the slot's generator state, then calls
        :meth:`preempt`)."""
        if not self.queue:
            return None
        free = self.free_slots()
        if not free:
            return None
        req = self.queue[0]
        need = self.blocks_needed(req)
        try:
            blocks, prefix_len, cow_src = self._alloc_with_prefix(req)
        except PoolExhausted:
            # a preempted request must not preempt others: without
            # this, a continuation and its evictor ping-pong the pool
            # forever (observed in development) — each FRESH request
            # may force at most one eviction chain, so total evictions
            # are bounded by the number of submissions
            if req.prior_tokens:
                return None
            victim = self._eviction_victim(need)
            if victim is None:
                return None
            return ("evict", victim)
        self.queue.popleft()
        slot = free[0]
        self._install(slot, req, blocks, prefix_len=prefix_len,
                      cow_src=cow_src)
        return ("admit", slot, req)

    def _alloc_with_prefix(self, req: Request):
        """The admission allocation: probe the prefix index over the
        prompt's full aligned blocks, INCREF every matched block into
        the new slot's row, allocate the rest fresh.  Returns
        ``(row blocks, prefix_len, cow_src)``; atomic — a
        :class:`PoolExhausted` mid-way rolls the increfs back so a
        failed admission holds nothing.  A full aligned match pops its
        LAST block into ``cow_src`` (pinned by an incref until the
        engine's copy finishes): the first-token logits need
        the last prompt token's forward pass, whose KV rewrite must
        land in a private copy-on-write fork, never a shared block."""
        need = self.blocks_needed(req)
        a = self.allocator
        if not self.prefix_cache:
            return a.alloc(need, req), 0, None
        prompt = np.asarray(req.prompt)
        matched: List[int] = []
        for h in prefix_block_hashes(prompt, self.block_size):
            b = a.lookup(h)
            if b is None:
                break
            matched.append(b)
        n = len(prompt)
        cow_src = None
        if matched and len(matched) * self.block_size == n:
            cow_src = matched.pop()
        # incref matched FIRST: a matched block parked in the
        # refcount-0 cache must not be reclaimed by our own fresh
        # alloc below
        taken: List[int] = []
        try:
            for b in matched:
                a.share(b, req)
                taken.append(b)
            if cow_src is not None:
                a.share(cow_src, req)
                taken.append(cow_src)
            fresh = a.alloc(need - len(matched), req)
        except PoolExhausted:
            for b in reversed(taken):
                a.free([b], req)
            raise
        prefix_len = n if cow_src is not None \
            else len(matched) * self.block_size
        self.prefix_probes += 1
        if prefix_len > 0:
            self.prefix_hits += 1
        return matched + fresh, prefix_len, cow_src

    def probe_prefix_tokens(self, prompt) -> int:
        """Side-effect-free prefix probe: how many leading prompt tokens
        the index covers now (0 when sharing is off) — the disaggregated
        router's straight-to-decode routing signal."""
        if not self.prefix_cache:
            return 0
        m = 0
        for h in prefix_block_hashes(np.asarray(prompt), self.block_size):
            if self.allocator.lookup(h) is None:
                break
            m += 1
        return m * self.block_size

    def _eviction_victim(self, need: int) -> Optional[int]:
        """Youngest-admitted active slot whose blocks would make the
        admission possible; never the only active slot.  Only the
        victim's PRIVATE references count as freed — a shared block
        survives its decref, and the allocator's refcount-0 cache is
        already reclaimable without anyone's eviction."""
        if self.n_active() < 2:
            return None
        cands = [(s.admit_seq, i) for i, s in enumerate(self.slots)
                 if s is not None]
        _seq, victim = max(cands)
        s = self.slots[victim]
        freed = sum(1 for b in s.blocks
                    if self.allocator.refcount(b) == 1)
        if s.cow_src is not None \
                and self.allocator.refcount(s.cow_src) == 1:
            freed += 1
        if self.allocator.reclaimable_count + freed < need:
            return None
        return victim

    def _install(self, slot: int, req: Request,
                 blocks: List[int], prefix_len: int = 0,
                 cow_src: Optional[int] = None) -> None:
        self.slots[slot] = _Slot(request=req, blocks=blocks, emitted=[],
                                 admit_seq=self._admit_seq,
                                 prefix_len=prefix_len, cow_src=cow_src,
                                 chain_hash=chain_seed(self.block_size))
        self._admit_seq += 1
        row = np.full(self.max_blocks_per_slot, TRASH_BLOCK, np.int32)
        row[:len(blocks)] = blocks
        self.page_table[slot] = row
        self.lengths[slot] = 0          # engine sets after prefill
        self.active[slot] = False       # engine arms after prefill
        self.temperature[slot] = req.temperature
        self.top_k[slot] = req.top_k
        self.top_p[slot] = req.top_p
        self._m_admit.inc()
        self._update_gauges()

    # -- engine callbacks ---------------------------------------------

    def arm(self, slot: int, first_token: int, prompt_len: int) -> None:
        """Prefill done: record the first sampled token and enter the
        slot into the decode batch.  Under prefix sharing the prompt's
        full aligned blocks register in the content index here."""
        self.slots[slot].emitted.append(int(first_token))
        self.last_tok[slot] = int(first_token)
        self.lengths[slot] = prompt_len
        self.active[slot] = True
        self._advance_registration(slot)

    def record_token(self, slot: int, token: int) -> bool:
        """Append one decoded token; returns True when the slot is
        finished (budget spent or EOS)."""
        s = self.slots[slot]
        s.emitted.append(int(token))
        self.last_tok[slot] = int(token)
        self.lengths[slot] += 1
        if self.prefix_cache and self.lengths[slot] % self.block_size == 0:
            # a decode-filled block just completed: register it so a
            # multi-turn follow-up (prompt = this conversation's
            # history) matches generated spans too, not just prompts
            self._advance_registration(slot)
        done = len(s.emitted) >= s.request.max_new_tokens
        if s.request.eos_id is not None and int(token) == s.request.eos_id:
            done = True
        return done

    def _advance_registration(self, slot: int) -> None:
        """Register every fully-WRITTEN block of ``slot`` not yet
        content-addressed: chain-hash the slot's token history block
        by block (position ``p`` holds ``prompt[p]`` below the prompt
        length and ``emitted[p - prompt_len]`` above it) and offer
        each to the allocator's index — a hash already mapped to
        another block leaves this one private (first registration is
        canonical), which is exactly what keeps a CoW fork out of the
        index its source owns."""
        if not self.prefix_cache:
            return
        s = self.slots[slot]
        bs = self.block_size
        full = int(self.lengths[slot]) // bs
        if s.hashed_blocks >= full:
            return
        n = len(s.request.prompt)
        prompt = np.asarray(s.request.prompt)
        while s.hashed_blocks < full:
            i = s.hashed_blocks
            toks = [int(prompt[p]) if p < n else s.emitted[p - n]
                    for p in range(i * bs, (i + 1) * bs)]
            s.chain_hash = chain_step(s.chain_hash, toks)
            self.allocator.register(int(s.blocks[i]), s.chain_hash)
            s.hashed_blocks += 1
        self._update_gauges()

    def finish_cow(self, slot: int) -> None:
        """The engine's copy of the CoW fork landed: drop the
        pin on the fork source (it stays registered/cached for the
        next hit; this slot's private copy at the same row is now the
        write target)."""
        s = self.slots[slot]
        if s.cow_src is not None:
            self.allocator.free([s.cow_src], s.request)
            s.cow_src = None
            self._update_gauges()

    def _release_blocks(self, s: _Slot) -> None:
        """Decref everything a slot holds — its page-table row AND a
        still-pinned CoW source (a retire/preempt racing the fork must
        not leak the pin)."""
        blocks = list(s.blocks)
        if s.cow_src is not None:
            blocks.append(s.cow_src)
            s.cow_src = None
        self.allocator.free(blocks, s.request)

    def retire(self, slot: int) -> Tuple[str, np.ndarray]:
        """Free the slot and its blocks; returns ``(uid, tokens)`` with
        the request's FULL generated stream (pre-preemption tokens
        included)."""
        s = self.slots[slot]
        self._release_blocks(s)
        self._clear(slot)
        self._m_retire.inc()
        self._update_gauges()
        toks = list(s.request.prior_tokens) + s.emitted
        return s.request.uid, np.asarray(toks, np.int32)

    def continuation(self, slot: int,
                     resume_key: np.ndarray) -> Request:
        """The recompute-on-resume continuation record for a live
        slot: original prompt extended with every generated token,
        remaining budget, ``prior_tokens`` carried, and the generator
        state the stream resumes with."""
        s = self.slots[slot]
        req = s.request
        done_tokens = list(req.prior_tokens) + s.emitted
        remaining = req.max_new_tokens - len(s.emitted)
        if remaining < 1:
            raise RuntimeError(
                f"{req.uid}: continuing a finished slot (bug: retire "
                f"should have run first)")
        return dataclasses.replace(
            req,
            prompt=np.concatenate(
                [np.asarray(req.prompt, np.int32),
                 np.asarray(s.emitted, np.int32)]),
            max_new_tokens=remaining,
            prior_tokens=tuple(int(t) for t in done_tokens),
            resume_key=np.asarray(resume_key),
        )

    def preempt(self, slot: int, resume_key: np.ndarray) -> Request:
        """Evict ``slot`` (recompute-on-resume): blocks free, and the
        :meth:`continuation` — original prompt + generated tokens,
        remaining budget, the slot's generator state — joins the BACK of the
        queue.  Returns the continuation."""
        cont = self.continuation(slot, resume_key)
        s = self.slots[slot]
        self._release_blocks(s)
        self._clear(slot)
        self.queue.append(cont)
        self._m_preempt.inc()
        self._update_gauges()
        return cont

    def _clear(self, slot: int) -> None:
        self.slots[slot] = None
        self.page_table[slot] = TRASH_BLOCK
        self.lengths[slot] = 0
        self.last_tok[slot] = 0
        self.active[slot] = False
        self.temperature[slot] = 0.0
        self.top_k[slot] = 0
        self.top_p[slot] = 1.0

    def idle(self) -> bool:
        return not self.queue and self.n_active() == 0
