"""Bring a JAX GPT checkpoint across: ``params_from_jax``.

The JAX parameter tree arrives as nested dicts of numpy arrays, in the
loop layout (``block_{i}`` subtrees) or the scan layout
(``layers/block`` with a leading layer axis, unstacked here).  Names map
one to one onto :class:`~apex_tpu_torch.models.gpt.GPTModel`'s
parameters (``block_0/attention/qkv/kernel`` ->
``block_0.attention.qkv.kernel``); :class:`~apex_tpu_torch.layers.Dense`
keeps flax's ``(in, out)`` kernel layout, so nothing is transposed.
bf16 arrays (``ml_dtypes.bfloat16``) convert through float32, which is
exact.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from apex_tpu_torch.ops import DeviceLike, resolve_device

#: path fragments of normalization parameters, which the O2 serving cast
#: keeps in float32 (the JAX package's ``default_keep_fp32_filter``)
_NORM_NAME_FRAGMENTS = ("batchnorm", "layernorm", "groupnorm", "norm", "bn")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Dict[Tuple[str, ...], Any]:
    out: Dict[Tuple[str, ...], Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def _to_tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))       # a writable copy


def _target_dtype(path: Tuple[str, ...], t: torch.Tensor,
                  dtype: Optional[torch.dtype]) -> torch.dtype:
    if dtype is None or not t.is_floating_point():
        return t.dtype
    if any(frag in name.lower() for name in path
           for frag in _NORM_NAME_FRAGMENTS):
        return torch.float32
    return dtype


def params_from_jax(tree: Mapping, cfg: GPTConfig,
                    device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> GPTModel:
    """A :class:`GPTModel` on ``device`` (the card by default) holding
    the JAX parameters ``tree``.  ``dtype=None`` keeps each leaf's dtype;
    ``dtype=torch.bfloat16`` is the O2 serving cast (every floating leaf
    to bf16 except normalization-named paths, as the JAX package's
    ``amp.model_params_from`` does).  The model's parameters do not
    require grad: the kernels have no backward yet."""
    device = resolve_device(device)
    flat = _flatten(tree)
    if any(p[0] == "layers" for p in flat):
        stacked = {p: v for p, v in flat.items() if p[0] == "layers"}
        flat = {p: v for p, v in flat.items() if p[0] != "layers"}
        for p, v in stacked.items():
            if p[:2] != ("layers", "block"):
                raise ValueError(f"unexpected scan-layout path {p}")
            arr = np.asarray(v)
            if arr.shape[0] != cfg.num_layers:
                raise ValueError(f"{'/'.join(p)} stacks {arr.shape[0]} "
                                 f"layers, config has {cfg.num_layers}")
            for i in range(cfg.num_layers):
                flat[(f"block_{i}",) + p[2:]] = arr[i]
    state = {}
    for path, v in flat.items():
        t = _to_tensor(v)
        state[".".join(path)] = t.to(device=device,
                                     dtype=_target_dtype(path, t, dtype))
    model = GPTModel(cfg, device="meta")
    want = set(model.state_dict())
    if set(state) != want:
        raise ValueError(
            f"parameter names differ from GPTModel's: missing "
            f"{sorted(want - set(state))}, unexpected "
            f"{sorted(set(state) - want)}")
    model.load_state_dict(state, assign=True)
    return model.requires_grad_(False).eval()
