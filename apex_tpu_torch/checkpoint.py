"""Checkpoint and resume of amp training state, as
``apex_tpu/checkpoint.py``.

The reference persisted fp32 masters and the scaler only through its two
FP16_Optimizer wrappers' ``state_dict`` and had no amp-level checkpoint:
the loss scalers were lost on a restart.  This module saves the whole
state of an :class:`~apex_tpu_torch.amp.Amp` (the fp32 masters, the
optimizer's moments and per-leaf step counts, every loss scaler, the step
count) and any extras (BatchNorm running buffers, an epoch counter)
through the durable snapshot layer
(:mod:`apex_tpu_torch.resilience.durable`): crash-atomic commits,
per-leaf sha256 checksums, async save off the step path, and a restore
that skips a corrupted or truncated snapshot for the last good one.

The payload is the JAX package's, leaf for leaf under the same names::

    {"master_params": {...},           # nested by the parameter names
     "opt_state": OptState(step, m, v, leaf_step),
     "scaler_states": [{"loss_scale", "unskipped"}, ...],
     "step": ...,
     "fp8_state": Fp8TrainState(input, weight, grad) or None,
     "extras": {...}}

so a snapshot of either package restores into the other's state.
``fp8_state`` is O4's delayed-scaling state (each class's
``amax_history`` and ``scale``, in the NamedTuples' field order), None
below O4, which contributes no leaves.  The compute parameters (bf16
under O2) are not saved: a restore refreshes them from the restored
masters, as the JAX package recomputes them.

A restore copies into the state's own tensors (``copy_``), never rebinds
them: FusedAdam's per-leaf step counts are views into one vector that
K11 reads, and its chunk tables keep the moments' device addresses.

App-level pattern::

    mgr = CheckpointManager(dir, max_to_keep=3)
    mgr.save(step, amp, extras={"batch_stats": buffers, "epoch": e})
    amp, extras = mgr.restore(amp, extras=...)   # on resume, in place
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch.amp.frontend import Amp
from apex_tpu_torch.amp.scaler import LossScaleState
from apex_tpu_torch.resilience.durable import (DurableCheckpointManager,
                                               as_tensor, host_copies,
                                               pinned_views,
                                               tree_leaves_with_path,
                                               tree_map_with_path)


class OptState(NamedTuple):
    """The optimizer's part of a payload, the JAX package's
    ``FusedAdamState`` / ``FusedLAMBState`` fields: ``step`` the global
    schedule counter, ``m`` / ``v`` the moments and ``leaf_step`` the
    per-leaf counts, each nested by the parameter names."""

    step: Any
    m: Any
    v: Any
    leaf_step: Any


def _nest(named: Iterable[Tuple[str, Any]]) -> Dict[str, Any]:
    """``{"a.b": x}`` -> ``{"a": {"b": x}}`` (the flax tree of the
    parameter names)."""
    out: Dict[str, Any] = {}
    for name, value in named:
        node = out
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def _opt_state(amp: Amp) -> OptState:
    opt = amp.optimizer
    if not hasattr(opt, "init_state"):
        raise TypeError(
            f"checkpoint: {type(opt).__name__} is not one of the port's "
            "fused optimizers (FusedAdam, FusedLAMB), whose moments and "
            "per-leaf step counts the payload names")
    opt.init_state()
    name_of = {id(t): n for n, t in amp.masters.items()}
    m, v, steps = [], [], []
    for group in opt.param_groups:
        for p in group["params"]:
            st, name = opt.state[p], name_of[id(p)]
            m.append((name, st["exp_avg"]))
            v.append((name, st["exp_avg_sq"]))
            steps.append((name, st["step"]))
    return OptState(step=opt.schedule_step(), m=_nest(m), v=_nest(v),
                    leaf_step=_nest(steps))


def payload_template(amp: Amp, extras: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """The nested layout of a checkpoint payload, holding the state's own
    tensors (no copy): what the durable layer flattens to name leaves,
    and what :func:`state_dict` copies to the host."""
    return {
        "master_params": _nest(amp.masters.items()),
        "opt_state": _opt_state(amp),
        "scaler_states": [
            {"loss_scale": s.loss_scale, "unskipped": s.unskipped}
            for s in amp.scaler_states],
        "step": amp.step,
        # O4's delayed-scaling state; None below O4 holds no leaves, so
        # pre-fp8 payloads and templates keep matching
        "fp8_state": amp.fp8_state,
        # always present (possibly empty), so that save and restore
        # structures match whenever both sides pass the same extras
        "extras": extras if extras else {},
    }


def state_dict(amp: Amp, extras: Optional[Dict[str, Any]] = None
               ) -> Dict[str, Any]:
    """The payload as host copies, complete when this returns: CPU tensors
    in their own dtypes (the card's in one pinned buffer), other extras
    as numpy arrays.  The copies wait for the work queued before them, so
    they hold the state as of the last step queued; a CPU tensor is
    copied too, since the next step changes it in place."""
    template = payload_template(amp, extras)
    copies = iter(host_copies([leaf for _, leaf in
                               tree_leaves_with_path(template)]))
    return tree_map_with_path(lambda _k, _leaf: next(copies), template)


def check_same_structure(saved_keys: Iterable[str],
                         template_keys: Iterable[str],
                         context: str = "checkpoint") -> None:
    """Raise ``ValueError`` naming the first diverging leaf path when the
    saved and template leaf sets differ, in both directions."""
    saved, tmpl = set(saved_keys), set(template_keys)
    if saved == tmpl:
        return
    missing = sorted(tmpl - saved)      # template expects, checkpoint lacks
    extra = sorted(saved - tmpl)        # checkpoint has, template lacks
    first = missing[0] if missing else extra[0]
    detail = []
    if missing:
        detail.append(f"missing from {context}: {missing[:3]}"
                      + (" ..." if len(missing) > 3 else ""))
    if extra:
        detail.append(f"not in template: {extra[:3]}"
                      + (" ..." if len(extra) > 3 else ""))
    raise ValueError(
        f"structural mismatch between {context} and template at leaf "
        f"{first!r} ({'; '.join(detail)}; {len(saved)} saved vs "
        f"{len(tmpl)} template leaves).  The model and optimizer must be "
        "built as in the run that saved (the reference's load_state_dict "
        "contract).")


def _leaf_keys(tree: Any) -> Iterable[str]:
    return (k for k, _ in tree_leaves_with_path(tree))


@torch.no_grad()
def load_state_dict(amp: Amp, d: Dict[str, Any]) -> Tuple[Amp, Dict]:
    """Restore :func:`state_dict`'s output (host tensors or numpy arrays,
    from either package) into ``amp``, in place, and return ``(amp,
    extras)`` with ``extras`` as saved.  ``amp`` (built as the run that
    saved was) supplies the structure, devices and dtypes: each leaf is
    copied into its tensor, on that tensor's device and in its dtype, and
    the compute parameters are refreshed from the restored masters.  The
    loss scalers get new tensors, as every step gives them.  A
    structural mismatch raises naming the first diverging leaf path.

    The O2 -> O4 warm start: a payload without ``fp8_state`` (a pre-fp8
    checkpoint) restores into an O4 ``amp``, which keeps its fresh fp8
    state (the amax history is a running statistic of the new regime,
    not trained state); the masters, moments and scalers restore."""
    target = payload_template(amp)
    del target["extras"]    # extras follow their own (optional) contract
    if amp.fp8_state is not None and "fp8_state" not in d:
        del target["fp8_state"]
    saved = {k: d.get(k) for k in target}
    check_same_structure(_leaf_keys(saved), _leaf_keys(target))
    values = dict(tree_leaves_with_path(saved))
    # FusedAdam's schedule counter is derived (a fresh tensor): copying
    # into it changes nothing, as the per-leaf counts carry it
    _fill([(t, values[key]) for key, t in tree_leaves_with_path(target)
           if not key.startswith("['scaler_states']")])
    for p, master in zip(amp.params, amp.masters.values()):
        if p is not master:
            p.copy_(master)
    dev = amp.step.device
    amp.scaler_states = [
        LossScaleState(
            loss_scale=as_tensor(sd["loss_scale"]).to(
                device=dev, dtype=torch.float32).reshape(()).clone(),
            unskipped=as_tensor(sd["unskipped"]).to(
                device=dev, dtype=torch.int32).reshape(()).clone())
        for sd in d["scaler_states"]]
    return amp, d.get("extras", {})


def _fill(pairs) -> None:
    """``target.copy_(value)`` for each pair, complete when this returns.
    Host values bound for the card are staged in one pinned buffer (a
    numpy array read from a snapshot by one byte copy), then uploaded
    together and waited for once; a tensor already on the card or pinned
    goes as it is."""
    staged = []
    for t, v in pairs:
        if not t.is_cuda or (isinstance(v, torch.Tensor)
                             and (v.is_cuda or v.is_pinned())):
            t.copy_(as_tensor(v), non_blocking=t.is_cuda)
        else:
            staged.append((t, v if isinstance(v, torch.Tensor)
                           else np.asarray(v)))
    if staged:
        views = pinned_views([(tuple(v.shape), v.dtype
                               if isinstance(v, torch.Tensor)
                               else _torch_dtype(v)) for _, v in staged])
        for (t, v), pin in zip(staged, views):
            if isinstance(v, torch.Tensor):
                pin.copy_(v)
            else:
                np.copyto(pin.reshape(-1).view(torch.uint8).numpy(),
                          np.ascontiguousarray(v).reshape(-1).view(np.uint8))
            t.copy_(pin, non_blocking=True)
    for dev in {t.device for t, _ in pairs if t.is_cuda}:
        torch.cuda.current_stream(dev).synchronize()


def _torch_dtype(arr: np.ndarray) -> torch.dtype:
    """The tensor dtype of a stored array (``V2``: bf16's words)."""
    if arr.dtype.kind == "V":
        return as_tensor(np.zeros(0, arr.dtype)).dtype
    return torch.from_numpy(np.zeros(0, arr.dtype)).dtype


class CheckpointManager(DurableCheckpointManager):
    """Durable epoch / step checkpointing with retention: the whole amp
    state, the scalers resumed exactly (scale and good-step count).  A
    :class:`~apex_tpu_torch.resilience.durable.DurableCheckpointManager`
    with the JAX package's constructor signature."""

    def __init__(self, directory: str, max_to_keep: int = 3, **kwargs: Any):
        super().__init__(directory, max_to_keep=max_to_keep, **kwargs)
