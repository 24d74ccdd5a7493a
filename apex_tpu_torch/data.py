"""Host-to-device input pipeline, as ``apex_tpu/data.py``: batches copied
ahead of the step that takes them, with an optional transform on the
device (uint8 -> normalized fp32 images).

On the card this is the reference's ``data_prefetcher``
(``examples/imagenet/main_amp.py:256-290``): each host batch is copied
into pinned memory and sent with ``non_blocking`` copies on a side CUDA
stream, the ``transform`` runs on that stream too, and up to
``lookahead`` batches are in flight while the consumer's stream runs the
current step.  A batch is handed out after the consumer's stream has
been told to wait for that batch's work (an event recorded on the side
stream after it: the reference's ``wait_stream``, batch by batch, so a
batch further ahead is not waited for), and every tensor handed out is
``record_stream``-ed on the consumer's stream, so the caching allocator
does not reuse its memory while the step may still read it.

:func:`prefetch_to_device` is the generator; :class:`DataPrefetcher` the
reference-shaped object (``.next()`` returns ``None`` once the iterator
is exhausted).  The JAX package's ``sharding`` becomes ``device``, which
is the card by default, as for every entry point; ``device="cpu"`` (only
when the caller asks for it) moves batches with no stream.  A batch is a
tensor, a numpy array, or a tuple / list / dict tree of them.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, \
    Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from apex_tpu_torch.ops import DeviceLike, resolve_device

__all__ = ["DataPrefetcher", "IMAGENET_MEAN", "IMAGENET_STD",
           "host_synthetic_loader", "normalize_uint8", "prefetch_to_device"]

#: the reference prefetcher's normalization constants
#: (``examples/imagenet/main_amp.py:259-265``), RGB mean / std times 255
IMAGENET_MEAN = (0.485 * 255, 0.456 * 255, 0.406 * 255)
IMAGENET_STD = (0.229 * 255, 0.224 * 255, 0.225 * 255)

_CONSTANTS: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _constants(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fp32 mean and std on ``device``, made once (a later batch's
    normalize uploads nothing)."""
    pair = _CONSTANTS.get(device)
    if pair is None:
        pair = _CONSTANTS[device] = (
            torch.tensor(IMAGENET_MEAN, dtype=torch.float32).to(device),
            torch.tensor(IMAGENET_STD, dtype=torch.float32).to(device))
    return pair


def normalize_uint8(batch):
    """``(x, y)`` with ``x`` (uint8 NHWC images) as fp32 ``(x - mean) /
    std`` over the channel axis: a subtraction and an IEEE division in
    fp32, so the result is the same bits on the card, on the CPU and in
    the JAX package.  Pass as ``transform=``: it runs where the batch
    lies (on the card, on the prefetcher's side stream)."""
    x, y = batch
    mean, std = _constants(x.device)
    return (x.float() - mean) / std, y


def host_synthetic_loader(steps: int, batch: int, size: int, seed: int):
    """``steps`` uint8 host batches (numpy) ``(x (batch, size, size, 3),
    y (batch,) int32)`` cycling a pool of 4 made from ``seed``: the JAX
    package's stand-in for a real loader's output."""
    rng = np.random.RandomState(seed)
    pool = [(rng.randint(0, 256, (batch, size, size, 3), np.uint8),
             rng.randint(0, 1000, (batch,), np.int64).astype(np.int32))
            for _ in range(4)]
    for i in range(steps):
        yield pool[i % len(pool)]


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def prefetch_to_device(iterator: Iterable[Any], lookahead: int = 2,
                       transform: Optional[Callable[[Any], Any]] = None,
                       device: DeviceLike = None) -> Iterator[Any]:
    """Yield the batches of ``iterator`` on ``device`` with ``lookahead``
    batches' copies (and ``transform`` calls) already queued: while the
    consumer runs a step on batch N, batch N + 1 is on its way.  On the
    card the copies and the transform run on a side stream (see the
    module's docstring)."""
    if lookahead < 1:
        raise ValueError(f"lookahead must be >= 1, got {lookahead}")
    # checked here, not at the first batch
    return _prefetch(iterator, lookahead, transform, resolve_device(device))


def _prefetch(iterator, lookahead, transform, device) -> Iterator[Any]:
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None

    def produce(batch):
        if not cuda:
            out = pytree.tree_map(lambda x: _as_tensor(x).to(device), batch)
            return (transform(out) if transform is not None else out), None
        with torch.cuda.stream(side):
            host = pytree.tree_map(lambda x: _as_tensor(x).pin_memory(),
                                   batch)
            out = pytree.tree_map(
                lambda x: x.to(device, non_blocking=True), host)
            if transform is not None:
                out = transform(out)
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    def hand_out(item):
        out, done = item
        if done is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            for t in pytree.tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(consumer)
        return out

    queue: collections.deque = collections.deque()
    it = iter(iterator)
    for batch in it:
        queue.append(produce(batch))
        if len(queue) >= lookahead:
            break
    while queue:
        item = queue.popleft()
        nxt = next(it, None)
        if nxt is not None:
            queue.append(produce(nxt))
        yield hand_out(item)


class DataPrefetcher:
    """The reference-shaped prefetcher: :meth:`next` returns the next
    batch on the device, ``None`` once the iterator is exhausted.

    >>> pf = DataPrefetcher(loader, transform=normalize_uint8)
    >>> batch = pf.next()
    >>> while batch is not None:
    ...     step(*batch)
    ...     batch = pf.next()
    """

    def __init__(self, iterator: Iterable[Any], lookahead: int = 2,
                 transform: Optional[Callable[[Any], Any]] = None,
                 device: DeviceLike = None):
        self._gen = prefetch_to_device(iterator, lookahead=lookahead,
                                       transform=transform, device=device)

    def next(self) -> Any:
        return next(self._gen, None)

    def __iter__(self):
        return self._gen
