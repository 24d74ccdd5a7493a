"""KV shipment between the fleet's slices: the transfer path of the
disaggregated prefill / decode fleet, as ``apex_tpu/serve/transfer.py``.

A disaggregated fleet runs prefill (compute-bound, bursty) and decode
(memory-bound, steady) on separate slices, so a request's KV cache moves
between block pools on different devices after its prefill:

- **slice layout** (:func:`slice_fleet`): one prefill slice plus N decode
  slices, each a tuple of ``torch.device``; a replica runs on its slice's
  first device (:func:`placement`; PyTorch has no replicated placement
  within a slice).  Like JAX's, the carve checks only that there are
  enough devices: a list that repeats one device passes, and then the
  slices share that card (and replicas share one model's weights, each
  with its own pools);
- **shipment format** (:class:`KVShipment`): one fixed-shape bundle per
  prefilled request — every pool gathered through the slot's page-table
  row into ``(L, max_blocks_per_slot, block_size, ...)``
  (:func:`make_gather`; trash-padded entries gather trash that the
  destination's install writes back into ITS trash block), plus the first
  sampled token, the prompt length, the slot's generator state and the
  original request;
- **the wire** (:func:`ship`): copies the pools into fresh buffers on the
  destination device (a copy even when source and destination are one
  device, so the shipment never aliases the gather and the byte count is
  of bytes moved), and returns the count for the router's
  ``serve_kv_transfer_bytes``;
- **install** (:func:`make_install`): writes the shipped blocks into the
  destination replica's own pools at the page-table row its allocator
  assigned (``pool[:, row] = shipped``, in place) and sets the slot's
  generator to the shipped state.

The generator state is a host tensor (the port's generators live on the
host): 5056 bytes for a CPU ``torch.Generator``, where JAX ships an
8-byte key, so ``serve_kv_transfer_bytes`` exceeds JAX's by the
difference a shipment while the KV bytes are equal.

Recompute-on-miss is the router's fallback, not this module's: the
original request re-prefills on the decode replica through its own
admission path (:mod:`apex_tpu_torch.serve.router`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from apex_tpu_torch.ops import resolve_device


@dataclasses.dataclass(frozen=True)
class FleetSlices:
    """The fleet's device layout: ONE prefill slice plus ``len(decode)``
    decode slices, each a tuple of devices."""

    prefill: Tuple[torch.device, ...]
    decode: Tuple[Tuple[torch.device, ...], ...]

    @property
    def n_devices(self) -> int:
        return len(self.prefill) + sum(len(d) for d in self.decode)

    def describe(self) -> dict:
        """JSON-friendly slice table: the devices' names."""
        return {"prefill": [str(d) for d in self.prefill],
                "decode": [[str(d) for d in s] for s in self.decode]}


def placement(devices: Sequence[torch.device]) -> torch.device:
    """The device a slice's engine, pools and weights live on: its
    first."""
    return devices[0]


def slice_fleet(devices: Optional[Sequence] = None,
                n_prefill_devices: int = 1,
                n_decode_replicas: int = 2,
                devices_per_replica: int = 1) -> FleetSlices:
    """Carve ``devices`` (default: every visible card) into the fleet's
    slices, in order; a list shorter than the slices need is an error."""
    if devices is None:
        resolve_device()            # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    need = n_prefill_devices + n_decode_replicas * devices_per_replica
    if n_prefill_devices < 1 or n_decode_replicas < 1 \
            or devices_per_replica < 1:
        raise ValueError(
            f"need >= 1 prefill device, >= 1 decode replica, >= 1 "
            f"device per replica; got {n_prefill_devices}/"
            f"{n_decode_replicas}/{devices_per_replica}")
    if len(devices) < need:
        raise ValueError(
            f"fleet topology needs {need} devices "
            f"({n_prefill_devices} prefill + {n_decode_replicas} x "
            f"{devices_per_replica} decode), have {len(devices)}")
    prefill = tuple(devices[:n_prefill_devices])
    decode: List[Tuple[torch.device, ...]] = []
    off = n_prefill_devices
    for _ in range(n_decode_replicas):
        decode.append(tuple(devices[off:off + devices_per_replica]))
        off += devices_per_replica
    return FleetSlices(prefill=prefill, decode=tuple(decode))


def place_tree(tree: Any, device: torch.device) -> Any:
    """Every tensor of a nested dict / list / tuple moved to ``device``
    (``Tensor.to``: the same tensor where it already lives)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: place_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place_tree(v, device) for v in tree)
    return tree


# ---------------------------------------------------------------------------
# shipment
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVShipment:
    """One prefilled request, packaged for a decode slice: the per-pool
    gathers ``{name: (L, max_blocks_per_slot, block_size, ...)}``, the
    first sampled token, the prompt length (the destination slot's
    starting length), the slot's generator state (``uint8`` on the host)
    and the original :class:`~apex_tpu_torch.serve.scheduler.Request`
    (the destination allocates its FULL footprint, remaining budget
    included, as its own admission would)."""

    request: Any
    kv: Dict[str, torch.Tensor]
    first_token: int
    prompt_len: int
    key: torch.Tensor
    #: bytes of the bundle (counted at gather time, recorded by the
    #: router when the wire copy happens)
    nbytes: int = 0

    @property
    def uid(self) -> str:
        return self.request.uid


def shipment_bytes(kv: Dict[str, torch.Tensor], key: torch.Tensor) -> int:
    """Bytes the wire moves for one shipment (pools + generator state;
    the token and length ride the host-side control message)."""
    total = key.numel() * key.element_size()
    for t in kv.values():
        total += t.numel() * t.element_size()
    return total


def make_gather(pool_names: Sequence[str]) -> Callable:
    """The prefill worker's extraction: ``gather(pools, row)`` takes every
    named pool ``(L, num_blocks, ...)`` through a page-table ``row
    (max_blocks_per_slot,)`` into the shipment shape ``(L, mb, ...)``
    (``index_select`` on dim 1, a new tensor).  Trash-padded row entries
    gather trash-block contents, which the destination masks out by the
    slot's length and its install writes to its own trash block."""
    names = tuple(pool_names)

    def gather(pools: Dict[str, torch.Tensor],
               row: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {n: pools[n].index_select(1, row) for n in names}

    return gather


def make_install(pool_names: Sequence[str]) -> Callable:
    """The decode replica's installation: ``install(pools, generators,
    row, shipped, slot, key)`` writes every shipped pool into the
    replica's own pools at its allocator's page-table ``row``, in place,
    and sets generator ``slot`` to the shipped state ``key``."""
    names = tuple(pool_names)

    def install(pools: Dict[str, torch.Tensor],
                generators: List[torch.Generator], row: torch.Tensor,
                shipped: Dict[str, torch.Tensor], slot: int,
                key: torch.Tensor) -> None:
        for n in names:
            # a row's repeated trash entries all write block 0, which no
            # live page-table entry reads: which copy lands (undefined
            # on CUDA) does not matter there, and nowhere else may a row
            # repeat an index
            pools[n][:, row] = shipped[n]
        gen = torch.Generator()
        gen.set_state(key)
        generators[slot] = gen

    return install


def _copy_to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t)
    return out


def ship(shipment: KVShipment, dst: torch.device) -> KVShipment:
    """The wire: copy the shipment's pools into fresh buffers on
    ``dst`` (device to device; a copy even on one device) and its
    generator state into a fresh host tensor; returns the shipment
    pointing at the copies, ``nbytes`` stamped for the router's
    ``serve_kv_transfer_bytes``."""
    kv = {n: _copy_to(t, dst) for n, t in shipment.kv.items()}
    key = shipment.key.clone()
    return dataclasses.replace(shipment, kv=kv, key=key,
                               nbytes=shipment_bytes(kv, key))
