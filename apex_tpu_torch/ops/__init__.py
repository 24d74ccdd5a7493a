"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
``device`` they resolve to ``cuda`` and raise when there is no card.
There is no switch that sends a CUDA tensor to a kernel's plain version:
each kernel wrapper picks the plain version only for a CPU tensor.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None,
                   allow_meta: bool = False) -> torch.device:
    """``torch.device`` for an entry point: the card by default; raises
    when a card is wanted (``None`` or ``"cuda..."``) and none is
    present.  ``"cpu"`` runs the plain PyTorch versions; ``"meta"``
    (shapes only) passes where ``allow_meta`` (a model's constructor)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "meta" and allow_meta:
        return dev
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (want cuda or cpu)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def same_device(a: Union[str, torch.device],
                b: Union[str, torch.device]) -> bool:
    """Whether two device specs name the same device (``cuda`` means the
    current card)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)
