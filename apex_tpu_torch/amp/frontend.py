"""amp frontend: :func:`initialize` and :func:`make_train_step`, as
``apex_tpu/amp/frontend.py``.

The JAX package keeps a pure state machine (``AmpState``); the port keeps
the same state on an :class:`Amp` object, in PyTorch's way:

- the model's parameters are the compute params, cast per the policy in
  place (under O2 every floating parameter goes to bf16 except those whose
  path names a normalization layer: the JAX ``default_keep_fp32_filter``
  fragments, applied to the module's parameter path; GPT's ``ln1`` /
  ``ln2`` / ``ln_f`` match none, so they are cast too, as in JAX);
- with master weights on, the fp32 masters are clones of the incoming
  parameters, and the optimizer's parameter groups are rewired to them
  (the reference's master swap); otherwise the optimizer steps the model's
  parameters directly;
- the scaler state (scale, good-step count) and the step count are device
  tensors.

A step: the loss (in fp32) times the scale; gradients w.r.t. the compute
params; the K6 unscale ``g.float() * (1 / scale)`` into fp32 with one
device overflow flag (checked on the scaled gradients), into gradient
buffers kept beside the masters from step to step; the scaler
update; then FusedAdam on the masters, made conditional on that same flag
inside the K5 kernel and the step counts, with the bf16 compute params
refreshed from the new masters in the same pass.  An overflow skips the
step on the card: masters, moments and step counts stay as they were, and
the scale halves.  Nothing reads a device value back to the host.

Not ported yet: gradient accumulation (``accum_steps``), data-parallel
reduction (``axis_name`` / ``reduce_fn``), fp8 (O4), the AOT cache,
several losses (``num_losses``) and ``add_params``; O1's cast-ops context
is refused by :func:`initialize`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, \
    Union

import torch
from torch import nn

from apex_tpu_torch.amp import policy as policy_lib
from apex_tpu_torch.amp.policy import Properties
from apex_tpu_torch.amp.scaler import LossScaler, LossScaleState
from apex_tpu_torch.ops import DeviceLike, resolve_device, same_device

#: name fragments of normalization parameters kept in fp32 under
#: keep_batchnorm_fp32 (the JAX package's ``default_keep_fp32_filter``)
_NORM_NAME_FRAGMENTS = ("batchnorm", "layernorm", "groupnorm", "norm", "bn")


def default_keep_fp32_filter(path: Sequence[str]) -> bool:
    """True for parameter paths that look like normalization params."""
    return any(frag in str(name).lower() for name in path
               for frag in _NORM_NAME_FRAGMENTS)


def _cast_floats(tree: Any, dtype: torch.dtype) -> Any:
    """Cast every floating tensor of a (nested tuple / list / dict) tree to
    ``dtype``, leaving integer tensors and non-tensors alone."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_floats(t, dtype) for t in tree)
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    return tree


class Amp:
    """A model and its optimizer bound to a mixed-precision policy (what
    :func:`initialize` returns).

    Attributes: ``properties``, ``scaler``, ``model``, ``optimizer``,
    ``params`` (the compute params, in the model's parameter order),
    ``masters`` (``{name: fp32 tensor}``; the compute params themselves
    when master weights are off), ``scaler_state`` and ``step`` (device
    int32: iterations run, skipped ones included)."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 properties: Properties, scaler: LossScaler,
                 keep_fp32_filter: Callable = default_keep_fp32_filter):
        if properties.cast_ops:
            raise NotImplementedError(
                f"{properties.opt_level}: the O1 cast-ops context is not "
                f"ported to apex_tpu_torch yet (use O0, O2 or O3)")
        self.properties = properties
        self.scaler = scaler
        self.model = model
        self.optimizer = optimizer
        self.keep_fp32_filter = keep_fp32_filter
        named = list(model.named_parameters())
        if not named:
            raise ValueError("the model has no parameters")
        dev = named[0][1].device
        use_masters = properties.enabled and properties.use_master_weights
        with torch.no_grad():
            masters = {n: p.detach().to(torch.float32, copy=True)
                       for n, p in named} if use_masters else None
            for n, p in named:
                dt = self._cast_leaf_dtype(n)
                if dt is not None and p.is_floating_point() \
                        and p.dtype != dt:
                    p.data = p.data.to(dt)
        self.params: List[nn.Parameter] = [p for _, p in named]
        if masters is None:
            self.masters: Dict[str, torch.Tensor] = dict(named)
        else:
            self.masters = masters
            by_id = {id(p): masters[n] for n, p in named}
            for group in optimizer.param_groups:
                group["params"] = [by_id[id(p)] for p in group["params"]]
        order = [id(t) for g in optimizer.param_groups for t in g["params"]]
        if sorted(order) != sorted(id(t) for t in self.masters.values()):
            raise ValueError("the optimizer must hold exactly the model's "
                             "parameters")
        # the compute param matching each optimizer tensor, in its order
        compute_of = {id(self.masters[n]): p for n, p in named}
        self._copies = [compute_of[i] for i in order] if use_masters \
            else None
        #: fp32 gradient buffers of the masters, made at the first step and
        #: unscaled into at every step: their storage never moves, so a
        #: whole-tree optimizer's pointer rows (FusedLAMB's chunk table)
        #: are uploaded once
        self._grads: Optional[List[torch.Tensor]] = None
        self.scaler_state: LossScaleState = scaler.init_state(dev)
        self.step = torch.zeros((), dtype=torch.int32, device=dev)

    def _cast_leaf_dtype(self, name: str) -> Optional[torch.dtype]:
        p = self.properties
        if not p.enabled or p.cast_model_dtype is None:
            return None
        if p.keep_batchnorm_fp32 and self.keep_fp32_filter(name.split(".")):
            return torch.float32
        return p.cast_model_dtype

    def run(self, fn: Callable, *args, **kwargs):
        """``fn(*args, **kwargs)`` with floating inputs cast to the
        compute dtype and the outputs cast to fp32 (or
        ``cast_model_outputs``) when the model is cast to a half dtype."""
        p = self.properties
        half = p.enabled and p.cast_model_dtype is not None \
            and p.cast_model_dtype != torch.float32
        if half:
            args, kwargs = _cast_floats((args, kwargs), p.cast_model_dtype)
        out = fn(*args, **kwargs)
        if half:
            out = _cast_floats(out, p.cast_model_outputs or torch.float32)
        return out

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """``loss.float() * loss_scale``."""
        if not self.properties.enabled:
            return loss
        return self.scaler.scale_loss(loss, self.scaler_state)

    @torch.no_grad()
    def apply_gradients(self, grads: Sequence[torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """Unscale, finite check, scaler update and the conditional
        optimizer step, for ``grads`` w.r.t. :attr:`params` (still scaled,
        in the compute dtype).  Returns device tensors ``overflow``,
        ``loss_scale`` (after the update) and ``pinned_at_floor``."""
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for "
                             f"{len(self.params)} parameters")
        if not self.properties.enabled:
            unscaled = [g.float() for g in grads]
            flag = None
            overflow = torch.zeros((), dtype=torch.bool,
                                   device=self.step.device)
        else:
            if self._copies is not None and self._grads is None:
                self._grads = [torch.empty_like(t, dtype=torch.float32)
                               for t in self.masters.values()]
            unscaled, flag = self.scaler.unscale(grads, self.scaler_state,
                                                 out=self._grads)
            self.scaler_state, overflow = self.scaler.update(
                self.scaler_state, flag == 0)
        names = list(self.masters)
        for name, g in zip(names, unscaled):
            target = self.masters[name]
            target.grad = g if g.dtype == target.dtype else g.to(
                target.dtype)
        self.optimizer.step(noop_flag=flag, model_params=self._copies)
        for t in self.masters.values():
            t.grad = None
        self.step += 1
        return {"overflow": overflow,
                "loss_scale": self.scaler_state.loss_scale,
                "pinned_at_floor": self.scaler.pinned_at_floor(
                    self.scaler_state)}


def initialize(model: nn.Module, optimizer: torch.optim.Optimizer,
               opt_level: str = "O1", enabled: bool = True,
               half_dtype: torch.dtype = torch.bfloat16,
               cast_model_dtype=None, cast_ops: Optional[bool] = None,
               keep_batchnorm_fp32: Union[None, bool, str] = None,
               master_weights: Optional[bool] = None,
               loss_scale: Union[None, float, str] = None,
               cast_model_outputs=None,
               min_loss_scale: Optional[float] = None,
               max_loss_scale: float = 2.0 ** 24,
               keep_fp32_filter: Callable = default_keep_fp32_filter,
               device: DeviceLike = None) -> Amp:
    """Bind ``model`` (fp32 parameters) and ``optimizer`` (built over
    them, e.g. :class:`~apex_tpu_torch.optimizers.FusedAdam`) to an opt
    level and overrides: casts the model in place, makes the fp32 masters
    and moves the optimizer onto them.  The model must lie on ``device``
    (the card by default; ``device="cpu"`` runs the plain versions)."""
    device = resolve_device(device)
    for p in model.parameters():
        if not same_device(p.device, device):
            raise ValueError(f"model is on {p.device}, not {device}")
    props = policy_lib.resolve(
        opt_level=opt_level, half_dtype=half_dtype, enabled=enabled,
        cast_model_dtype=cast_model_dtype, cast_ops=cast_ops,
        keep_batchnorm_fp32=keep_batchnorm_fp32,
        master_weights=master_weights, loss_scale=loss_scale,
        cast_model_outputs=cast_model_outputs)
    scaler = LossScaler(loss_scale=props.loss_scale,
                        min_loss_scale=min_loss_scale,
                        max_loss_scale=max_loss_scale)
    return Amp(model, optimizer, props, scaler, keep_fp32_filter)


def make_train_step(amp: Amp, model: nn.Module,
                    loss_fn: Callable) -> Callable:
    """``step(*batch) -> {"loss", "overflow", "loss_scale",
    "pinned_at_floor"}`` (device tensors): ``loss_fn(model, *batch)`` at
    compute precision, its fp32 loss scaled, the backward, then
    :meth:`Amp.apply_gradients`.  ``model`` is the one ``amp`` was
    initialized with.  The step makes no host sync."""
    if model is not amp.model:
        raise ValueError("make_train_step: model is not the one amp was "
                         "initialized with")

    def step(*batch) -> Dict[str, torch.Tensor]:
        with torch.enable_grad():
            loss = amp.run(loss_fn, model, *batch)
            grads = torch.autograd.grad(amp.scale_loss(loss), amp.params)
        info = amp.apply_gradients(grads)
        return {"loss": loss.detach(), **info}

    return step
