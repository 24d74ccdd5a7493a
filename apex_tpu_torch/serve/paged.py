"""Paged KV cache: a physical block pool read through per-slot page
tables, as ``apex_tpu/serve/paged.py``.

- The pool is ``(L, num_blocks, block_size, H, D)``; a slot's page-table
  row maps its logical block ``j`` (positions ``j * block_size ..``) to a
  physical block, and :func:`gather_slot_kv` linearises every slot's
  cache back to ``(S, M, H, D)``.
- The int8 KV format (``ServeConfig(kv_dtype="int8")``) keeps int8 pools
  beside fp32 scale pools ``(L, num_blocks, block_size)``
  (:func:`make_scale_pools`), one scale a cached token and layer,
  linearised by :func:`gather_slot_scales` as the caches are.
- Physical block 0 is the trash block: never allocated, the target of
  every empty page-table entry and of the writes of inactive lanes and
  padding rows.
- :class:`BlockAllocator` is host bookkeeping: a free list with
  refcounted, content-addressed prefix blocks.  A full aligned block is
  registered under a chain hash of its whole token history, so equal
  hashes mean equal KV and sharing is exact; a registered block is
  immutable (the engine forks it copy-on-write before a write), and at
  refcount 0 it parks in an LRU cached list that ``alloc`` reclaims
  before the pool runs dry.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import torch

from apex_tpu_torch.models.generate import _attn_cached
from apex_tpu_torch.obs.stepclass import DECODE_RANGES
from apex_tpu_torch.utils.profiling import profile_range

#: physical block id reserved as the write target for masked/inactive
#: lanes; never allocated, never mapped by a live page-table entry
TRASH_BLOCK = 0


class PoolExhausted(RuntimeError):
    """Raised by :meth:`BlockAllocator.alloc` when the pool cannot serve
    the request; the scheduler catches it to drive eviction."""


def chain_seed(block_size: int) -> bytes:
    """Root of every prefix hash chain, binding the block size."""
    return hashlib.sha256(b"apex-tpu-prefix:%d" % block_size).digest()


def chain_step(h: bytes, tokens: Sequence[int]) -> bytes:
    """Extend chain hash ``h`` by one FULL block of token ids."""
    return hashlib.sha256(
        h + b"".join(int(t).to_bytes(8, "little", signed=True)
                     for t in tokens)).digest()


def prefix_block_hashes(tokens: Sequence[int],
                        block_size: int) -> List[bytes]:
    """Chain hashes of every FULL aligned block of ``tokens``."""
    out: List[bytes] = []
    h = chain_seed(block_size)
    for i in range(len(tokens) // block_size):
        h = chain_step(h, tokens[i * block_size:(i + 1) * block_size])
        out.append(h)
    return out


class BlockAllocator:
    """Host-side refcounted free-list allocator over the block pool with
    a content-addressed prefix index.

    Invariants: block 0 is never allocated, shared or registered;
    ``alloc`` never hands out a live block; ``free`` decrefs and rejects
    (atomically) blocks the caller does not hold; a registered block
    parks in the LRU cached list at refcount 0; free + live + cached
    blocks always number ``num_blocks - 1``.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 physical blocks (1 trash + 1 usable), got "
                f"{num_blocks}")
        self.num_blocks = num_blocks
        # pop() hands out low ids first — deterministic layouts in tests
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        #: block -> holder list (refcount == len)
        self._refs: Dict[int, List[object]] = {}
        #: registered block -> chain hash, and chain hash -> block
        self._hash: Dict[int, bytes] = {}
        self._index: Dict[bytes, int] = {}
        #: refcount-0 registered blocks, least-recently-freed first
        self._cached: "OrderedDict[int, None]" = OrderedDict()

    @property
    def live_count(self) -> int:
        return len(self._refs)

    @property
    def reclaimable_count(self) -> int:
        """Blocks an ``alloc`` can hand out now: free plus cached."""
        return len(self._free) + len(self._cached)

    @property
    def shared_count(self) -> int:
        """Blocks mapped by more than one holder."""
        return sum(1 for hs in self._refs.values() if len(hs) > 1)

    def refcount(self, block: int) -> int:
        return len(self._refs.get(block, ()))

    def alloc(self, n: int, owner: object) -> List[int]:
        """``n`` private blocks now held by ``owner``; reclaims LRU cached
        blocks once the free list is empty, and raises
        :class:`PoolExhausted` (taking nothing) when even that is short."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > self.reclaimable_count:
            raise PoolExhausted(
                f"need {n} blocks, {len(self._free)} free + "
                f"{len(self._cached)} cached "
                f"(pool {self.num_blocks}, 1 reserved)")
        blocks: List[int] = []
        for _ in range(n):
            if self._free:
                blocks.append(self._free.pop())
            else:
                victim, _ = self._cached.popitem(last=False)
                del self._index[self._hash.pop(victim)]
                blocks.append(victim)
        for b in blocks:
            self._refs[b] = [owner]
        return blocks

    def free(self, blocks: Sequence[int], owner: object) -> None:
        """Decref ``blocks``, all of which ``owner`` must hold (the call
        is rejected whole otherwise).  A block whose last reference drops
        returns to the free list, or to the cached list if registered."""
        for b in blocks:
            if not any(h is owner for h in self._refs.get(b, ())):
                raise ValueError(
                    f"block {b} not owned by {owner!r} "
                    f"(holders={self._refs.get(b)!r}) — double free or "
                    f"cross-owner free")
        for b in blocks:
            hs = self._refs[b]
            for i, h in enumerate(hs):
                if h is owner:
                    hs.pop(i)
                    break
            if not hs:
                del self._refs[b]
                if b in self._hash:
                    self._cached[b] = None
                else:
                    self._free.append(b)

    def share(self, block: int, owner: object) -> None:
        """Incref a registered block for ``owner`` (a prefix hit)."""
        if block not in self._hash:
            raise ValueError(
                f"block {block} is not registered — only "
                f"content-addressed blocks can be shared")
        if any(h is owner for h in self._refs.get(block, ())):
            raise ValueError(f"block {block} already held by {owner!r}")
        self._cached.pop(block, None)
        self._refs.setdefault(block, []).append(owner)

    def register(self, block: int, chain_hash: bytes) -> bool:
        """Mark a live block content-addressed under ``chain_hash``.
        False (the block stays private) when the hash already maps to
        another block; re-registering the same pair is a no-op; another
        hash for a registered block raises."""
        if block == TRASH_BLOCK or block not in self._refs:
            raise ValueError(
                f"block {block} is not live — register after alloc, "
                f"before free")
        have = self._hash.get(block)
        if have is not None:
            if have != chain_hash:
                raise ValueError(
                    f"block {block} already registered under a "
                    f"different chain hash")
            return True
        if chain_hash in self._index:
            return False
        self._hash[block] = chain_hash
        self._index[chain_hash] = block
        return True

    def lookup(self, chain_hash: bytes) -> Optional[int]:
        """The block registered under ``chain_hash``, or None."""
        return self._index.get(chain_hash)


def make_pools(num_layers: int, num_blocks: int, block_size: int,
               num_heads: int, head_dim: int, dtype: torch.dtype,
               device: torch.device):
    """Zeroed ``(kc, vc)`` pools ``(L, num_blocks, block_size, H, D)`` in
    ``dtype`` (the model's, or ``torch.int8`` for the int8 format)."""
    shape = (num_layers, num_blocks, block_size, num_heads, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def make_scale_pools(num_layers: int, num_blocks: int, block_size: int,
                     device: torch.device):
    """Zeroed fp32 ``(ks, vs)`` scale pools ``(L, num_blocks,
    block_size)``: the int8 format's one scale a cached token and layer
    (an unwritten position dequantizes to exact zeros)."""
    shape = (num_layers, num_blocks, block_size)
    return (torch.zeros(shape, dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.float32, device=device))


def gather_slot_kv(pool_l: torch.Tensor,
                   page_table: torch.Tensor) -> torch.Tensor:
    """``pool_l (num_blocks, bs, H, D)`` gathered by ``page_table (S,
    max_blocks)`` into ``(S, max_blocks * bs, H, D)``: position ``p`` of
    slot ``s`` lands at ``[s, p]``."""
    with profile_range(DECODE_RANGES["kv_read"]):
        g = pool_l[page_table]               # (S, MB, bs, H, D)
        s, mb, bs, h, d = g.shape
        return g.reshape(s, mb * bs, h, d)


def gather_slot_scales(pool_s: torch.Tensor,
                       page_table: torch.Tensor) -> torch.Tensor:
    """``pool_s (num_blocks, bs)`` gathered by ``page_table (S,
    max_blocks)`` into ``(S, max_blocks * bs)``: scale ``[s, p]`` belongs
    to position ``[s, p]`` of :func:`gather_slot_kv`'s output."""
    with profile_range(DECODE_RANGES["kv_read"]):
        g = pool_s[page_table]               # (S, MB, bs)
        s, mb, bs = g.shape
        return g.reshape(s, mb * bs)


def token_write_coords(lengths: torch.Tensor, page_table: torch.Tensor,
                       block_size: int, active: torch.Tensor):
    """``(blocks, offsets)`` ``(S,)`` for writing every slot's next token
    (position ``lengths[s]``); inactive slots route to the trash block."""
    mb = page_table.shape[1]
    idx = torch.clamp(lengths // block_size, 0, mb - 1)
    blocks = page_table.gather(1, idx[:, None])[:, 0]
    blocks = torch.where(active, blocks, torch.full_like(blocks,
                                                         TRASH_BLOCK))
    return blocks, lengths % block_size


def paged_attention(q: torch.Tensor, k_lin: torch.Tensor,
                    v_lin: torch.Tensor, valid: torch.Tensor,
                    scale: float, k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fp32-softmax attention of ``q (S, Lq, H, D)`` against the
    linearised caches ``(S, M, H, D)`` under ``valid (S, Lq, M)``; the
    math is :func:`apex_tpu_torch.models.generate._attn_cached`, so the
    engine and solo ``generate()`` share it.  ``k_scale`` / ``v_scale``
    ``(S, M)`` (from :func:`gather_slot_scales`) read int8 caches."""
    return _attn_cached(q, k_lin, v_lin, valid, scale, k_scale=k_scale,
                        v_scale=v_scale)
