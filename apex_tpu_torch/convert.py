"""Bring a JAX GPT or BERT checkpoint across (``params_from_jax``,
``bert_params_from_jax``) and back (``params_to_numpy``).

The JAX parameter tree arrives as nested dicts of numpy arrays, in the
loop layout (``block_{i}`` subtrees for GPT, ``bert/layer_{i}`` for
BERT) or the scan layout (``layers/block``, ``bert/layers/layer``, with
a leading layer axis, unstacked here).  Names map one to one onto the
port's module parameters (``block_0/attention/qkv/kernel`` ->
``block_0.attention.qkv.kernel``); :class:`~apex_tpu_torch.layers.Dense`
keeps flax's ``(in, out)`` kernel layout, so nothing is transposed.
bf16 arrays (``ml_dtypes.bfloat16``) convert through float32, which is
exact.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from apex_tpu_torch.amp.frontend import default_keep_fp32_filter
from apex_tpu_torch.models.bert import BertConfig, BertForPreTraining
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from apex_tpu_torch.ops import DeviceLike, resolve_device


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
    if default_keep_fp32_filter(path):      # normalization params stay fp32
        return torch.float32
    return dtype


def _unstack(flat: Dict[Tuple[str, ...], Any], scan: Tuple[str, ...],
             loop: Tuple[str, ...], num_layers: int
             ) -> Dict[Tuple[str, ...], Any]:
    """Scan-layout leaves under ``scan`` (a leading layer axis) become
    loop-layout leaves under ``loop[:-1] + (f"{loop[-1]}_{i}",)``."""
    head = scan[:-1]
    stacked = {p: v for p, v in flat.items() if p[:len(head)] == head}
    if not stacked:
        return flat
    out = {p: v for p, v in flat.items() if p not in stacked}
    for p, v in stacked.items():
        if p[:len(scan)] != scan:
            raise ValueError(f"unexpected scan-layout path {p}")
        arr = np.asarray(v)
        if arr.shape[0] != num_layers:
            raise ValueError(f"{'/'.join(p)} stacks {arr.shape[0]} "
                             f"layers, config has {num_layers}")
        for i in range(num_layers):
            out[loop[:-1] + (f"{loop[-1]}_{i}",) + p[len(scan):]] = arr[i]
    return out


def _load(model: nn.Module, tree: Mapping, scan: Tuple[str, ...],
          loop: Tuple[str, ...], num_layers: int, device: DeviceLike,
          dtype: Optional[torch.dtype], trainable: bool) -> nn.Module:
    """``model`` (built on the meta device) holding the JAX parameters
    ``tree`` on ``device``; see :func:`params_from_jax`."""
    device = resolve_device(device)
    flat = _unstack(_flatten(tree), scan, loop, num_layers)
    state = {}
    for path, v in flat.items():
        t = _to_tensor(v)
        state[".".join(path)] = t.to(device=device,
                                     dtype=_target_dtype(path, t, dtype))
    want = set(model.state_dict())
    if set(state) != want:
        raise ValueError(
            f"parameter names differ from {type(model).__name__}'s: "
            f"missing {sorted(want - set(state))}, unexpected "
            f"{sorted(set(state) - want)}")
    model.load_state_dict(state, assign=True)
    if trainable:
        return model.requires_grad_(True).train()
    return model.requires_grad_(False).eval()


def params_from_jax(tree: Mapping, cfg: GPTConfig,
                    device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None,
                    trainable: bool = False) -> GPTModel:
    """A :class:`GPTModel` on ``device`` (the card by default) holding
    the JAX parameters ``tree``.  ``dtype=None`` keeps each leaf's dtype;
    ``dtype=torch.bfloat16`` is the O2 serving cast (every floating leaf
    to bf16 except normalization-named paths, as the JAX package's
    ``amp.model_params_from`` does).  With ``trainable`` the parameters
    require grad and the model is in training mode (hand it to
    :func:`apex_tpu_torch.amp.initialize`, which makes the fp32 masters
    and the compute cast); otherwise they do not, for serving."""
    return _load(GPTModel(cfg, device="meta"), tree, ("layers", "block"),
                 ("block",), cfg.num_layers, device, dtype, trainable)


def bert_params_from_jax(tree: Mapping, cfg: BertConfig,
                         device: DeviceLike = None,
                         dtype: Optional[torch.dtype] = None,
                         trainable: bool = False) -> BertForPreTraining:
    """A :class:`~apex_tpu_torch.models.bert.BertForPreTraining` holding
    the JAX ``BertForPreTraining`` parameters ``tree`` (loop layout
    ``bert/layer_{i}`` or scan layout ``bert/layers/layer``); the options
    as :func:`params_from_jax`'s."""
    return _load(BertForPreTraining(cfg, device="meta"), tree,
                 ("bert", "layers", "layer"), ("bert", "layer"),
                 cfg.num_layers, device, dtype, trainable)


def params_to_numpy(params: Union[nn.Module, Mapping[str, torch.Tensor]]
                    ) -> Dict[str, Any]:
    """The flax-shaped nested dict of fp32 numpy arrays (loop layout,
    ``block_{i}/...``) of a model's parameters, or of a ``{dotted name:
    tensor}`` mapping such as :attr:`apex_tpu_torch.amp.Amp.masters`."""
    named = (dict(params.named_parameters()) if isinstance(params, nn.Module)
             else dict(params))
    out: Dict[str, Any] = {}
    for name, t in named.items():
        node = out
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().float().cpu().numpy()
    return out
