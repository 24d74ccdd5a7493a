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
params; the K6 unscale ``g.float() * (1 / scale)`` with one device
overflow flag (checked on the scaled gradients), into gradient buffers
kept beside the masters from step to step (in each master's dtype: fp32,
or bf16 under O3); the scaler update; then the optimizer on the masters
(FusedAdam: one K11 launch), made conditional on that same flag inside
the kernel and the step counts, with the bf16 compute params refreshed
from the new masters in the same pass.  An overflow skips the step on the
card: masters, moments and step counts stay as they were, and the scale
halves.  Nothing reads a device value back to the host.

Gradient accumulation (``make_train_step(..., accum_steps=N)``) follows
the JAX package's scan: every batch tensor splits into N micro-batches;
each micro-batch's scaled compute-dtype gradients are unscaled onto fp32
accumulators (one K10 launch, ``acc = (1 / scale) * g + acc``; amp's kept
buffers themselves when they are fp32); the sum is divided by N; then one
finite check of the accumulated gradients (K15, one launch over the tree:
an inf in any micro-batch persists through the adds and skips the step),
the scaler update and the optimizer step.

Under O1 (``cast_ops``) the parameters stay fp32 and are their own
masters: :meth:`Amp.run` enters the op layer's cast context
(:func:`apex_tpu_torch.amp.ops.cast_context`), so the layers' products
run in bf16 and the softmax, norms and losses in fp32, the gradients come
back fp32, the unscale is K6 on fp32 and Adam is K11 with no copies.

Several losses (``initialize(..., num_losses=N)``): one scaler state per
loss, :meth:`Amp.scale_loss` / :meth:`Amp.unscale_gradients` by
``loss_id``, and the pieces :meth:`Amp.update_scaler` and
:meth:`Amp.step_if`, which :meth:`Amp.apply_gradients_multi` drives: an
overflow in any backward skips the step, and each scaler moves only by
its own loss.

Data parallelism (``make_train_step(..., axis_name=, reduce_fn=)``, and
``reduce_fn`` on :meth:`Amp.apply_gradients` /
:meth:`Amp.apply_gradients_multi`): the reduce (e.g.
:class:`~apex_tpu_torch.parallel.DistributedDataParallel`'s) runs on the
scaled compute-dtype gradients before the unscale, as the JAX package's
and the reference DDP's do; with ``accum_steps`` once, on the
accumulated gradients, before the finite check, so an overflow on any
rank skips the step on every rank.

Not ported yet: ``finite_axes`` (it waits for the pipeline and expert
shards), fp8 (O4), the AOT cache and ``add_params``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, \
    Union

import inspect

import torch
import torch.utils._pytree as pytree
from torch import nn

from apex_tpu_torch.amp import ops as amp_ops
from apex_tpu_torch.amp import policy as policy_lib
from apex_tpu_torch.amp.policy import Properties
from apex_tpu_torch.amp.scaler import LossScaler, LossScaleState, all_finite
from apex_tpu_torch.ops import DeviceLike, resolve_device, same_device
from apex_tpu_torch.ops.multi_tensor import CHUNK_SIZE, multi_tensor_axpby

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
    return pytree.tree_map(
        lambda t: t.to(dtype) if isinstance(t, torch.Tensor)
        and t.is_floating_point() else t, tree)


class Amp:
    """A model and its optimizer bound to a mixed-precision policy (what
    :func:`initialize` returns).

    Attributes: ``properties``, ``scaler``, ``model``, ``optimizer``,
    ``params`` (the compute params, in the model's parameter order),
    ``masters`` (``{name: fp32 tensor}``; the compute params themselves
    when master weights are off), ``scaler_states`` (one per loss;
    ``scaler_state`` is loss 0's), ``num_losses`` and ``step`` (device
    int32: iterations run, skipped ones included)."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 properties: Properties, scaler: LossScaler,
                 keep_fp32_filter: Callable = default_keep_fp32_filter,
                 num_losses: int = 1):
        if int(num_losses) < 1:
            raise ValueError(f"num_losses must be >= 1, got {num_losses}")
        self.num_losses = int(num_losses)
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
        #: gradient buffers of the masters (:meth:`grad_buffers`) and the
        #: fp32 accumulators of ``accum_steps`` where those are not fp32
        self._grads: Optional[List[torch.Tensor]] = None
        self._acc: Optional[List[torch.Tensor]] = None
        self._one = torch.ones(1, dtype=torch.float32, device=dev)
        self.scaler_states: List[LossScaleState] = [
            scaler.init_state(dev) for _ in range(self.num_losses)]
        self.step = torch.zeros((), dtype=torch.int32, device=dev)
        #: whether the optimizer's step takes a device skip flag (the
        #: port's fused optimizers); another one is stepped from the host
        self._takes_flag = "noop_flag" in inspect.signature(
            optimizer.step).parameters

    @property
    def scaler_state(self) -> LossScaleState:
        """Loss 0's scaler state."""
        return self.scaler_states[0]

    @scaler_state.setter
    def scaler_state(self, state: LossScaleState) -> None:
        self.scaler_states[0] = state

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
        ``cast_model_outputs``) when the model is cast to a half dtype,
        and under O1 (``cast_ops``) inside the op layer's cast context."""
        p = self.properties
        half = p.enabled and p.cast_model_dtype is not None \
            and p.cast_model_dtype != torch.float32
        if half:
            args, kwargs = _cast_floats((args, kwargs), p.cast_model_dtype)
        if p.enabled and p.cast_ops:
            with amp_ops.cast_context(p):
                out = fn(*args, **kwargs)
        else:
            out = fn(*args, **kwargs)
        if half:
            out = _cast_floats(out, p.cast_model_outputs or torch.float32)
        return out

    def scale_loss(self, loss: torch.Tensor,
                   loss_id: int = 0) -> torch.Tensor:
        """``loss.float() * loss_scale`` of scaler ``loss_id``."""
        if not self.properties.enabled:
            return loss
        return self.scaler.scale_loss(loss, self.scaler_states[loss_id])

    def grad_buffers(self) -> List[torch.Tensor]:
        """The optimizer's gradients, one buffer per master in its dtype
        (fp32 masters; the parameters' own dtype without master weights,
        bf16 under O3), made at the first step and written at every step:
        their storage never moves, so a whole-tree optimizer's pointer
        rows (FusedAdam's and FusedLAMB's chunk tables) are uploaded
        once."""
        if self._grads is None:
            with torch.no_grad():
                self._grads = [torch.empty_like(t)
                               for t in self.masters.values()]
        return self._grads

    def accumulators(self) -> List[torch.Tensor]:
        """fp32 gradient accumulators, one per master: the
        :meth:`grad_buffers` themselves when those are fp32."""
        bufs = self.grad_buffers()
        if all(b.dtype == torch.float32 for b in bufs):
            return bufs
        if self._acc is None:
            with torch.no_grad():
                self._acc = [torch.empty_like(b, dtype=torch.float32)
                             for b in bufs]
        return self._acc

    @torch.no_grad()
    def accumulate(self, grads: Sequence[torch.Tensor],
                   acc: Sequence[torch.Tensor]) -> None:
        """``acc += grads`` in fp32 (one K10 launch per dtype group,
        ``acc = 1 * g + 1 * acc``), as JAX adds each micro-batch's
        gradients into fp32 zeros."""
        self._check_count(grads)
        multi_tensor_axpby(CHUNK_SIZE, [grads, acc], self._one, self._one,
                           out=acc)

    def _check_count(self, grads: Sequence[torch.Tensor]) -> None:
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for "
                             f"{len(self.params)} parameters")

    @torch.no_grad()
    def apply_gradients(self, grads: Sequence[torch.Tensor],
                        stashed_grads: Optional[Sequence[torch.Tensor]]
                        = None, loss_id: int = 0,
                        reduce_fn: Optional[Callable] = None
                        ) -> Dict[str, torch.Tensor]:
        """Unscale, finite check, scaler update and the conditional
        optimizer step, for ``grads`` w.r.t. :attr:`params` (still scaled
        by scaler ``loss_id``, in the compute dtype).  ``reduce_fn`` (a
        data-parallel reduce) runs first, on those scaled gradients.
        ``stashed_grads``
        (unscaled, one per parameter) selects the accumulation path,
        ``(1 / scale) * grads + stashed`` (K10), whose finite check (K15,
        :func:`~apex_tpu_torch.amp.scaler.all_finite`) covers the
        combined unscaled gradients: an inf from an earlier micro-batch
        persists through the adds, as in the JAX package.  Returns device
        tensors ``overflow``, ``loss_scale`` (after the update) and
        ``pinned_at_floor``."""
        if reduce_fn is not None:
            grads = reduce_fn(grads)
        self._check_count(grads)
        if not self.properties.enabled:
            return self.step_if([g.float() for g in grads], None)
        if stashed_grads is not None:
            self._check_count(stashed_grads)
            unscaled, _ = self.scaler.unscale_with_stashed(
                grads, stashed_grads, self.scaler_states[loss_id],
                out=self.grad_buffers())
            finite = all_finite(unscaled)
        else:
            unscaled, flag = self.scaler.unscale(
                grads, self.scaler_states[loss_id], out=self.grad_buffers())
            finite = flag == 0
        overflow = self.update_scaler(loss_id, finite)
        return self.step_if(unscaled, overflow, loss_id)

    @torch.no_grad()
    def unscale_gradients(self, grads: Sequence[torch.Tensor],
                          loss_id: int = 0,
                          stashed_grads: Optional[Sequence[torch.Tensor]]
                          = None
                          ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """One backward's gradients unscaled by scaler ``loss_id``,
        without stepping: ``(fp32 tensors, finite)``, ``finite`` a 0-dim
        bool device tensor.  With ``stashed_grads`` they are added onto
        the stash and only the new gradients are checked (the reference's
        arg-0 policy: a stale inf in the stash is not this backward's)."""
        state = self.scaler_states[loss_id]
        if stashed_grads is not None:
            out, flag = self.scaler.unscale_with_stashed(
                grads, stashed_grads, state)
        else:
            out, flag = self.scaler.unscale(grads, state)
        return out, (flag == 0).reshape(())

    @torch.no_grad()
    def update_scaler(self, loss_id: int,
                      grads_finite: torch.Tensor) -> torch.Tensor:
        """Scaler ``loss_id``'s post-backward transition, without
        stepping; returns ``overflow`` (0-dim bool, on the device)."""
        self.scaler_states[loss_id], overflow = self.scaler.update(
            self.scaler_states[loss_id], grads_finite)
        return overflow

    @torch.no_grad()
    def step_if(self, grads_unscaled: Sequence[torch.Tensor],
                skip: Optional[torch.Tensor], loss_id: int = 0
                ) -> Dict[str, torch.Tensor]:
        """The optimizer step on unscaled gradients (one per master, cast
        to its dtype), skipped where ``skip`` (0-dim bool on the device,
        or None) is true; the step count advances either way.  The port's
        fused optimizers take the skip as a device flag (no host sync);
        another optimizer (``torch.optim.SGD``) is stepped after reading
        the flag on the host.  Returns ``apply_gradients``' info, with
        scaler ``loss_id``'s scale."""
        self._check_count(grads_unscaled)
        if skip is None:
            skip = torch.zeros((), dtype=torch.bool, device=self.step.device)
        for target, g in zip(self.masters.values(), grads_unscaled):
            target.grad = g if g.dtype == target.dtype else g.to(
                target.dtype)
        if self._takes_flag:
            flag = None if not self.properties.enabled \
                else skip.to(torch.int32).reshape(1)
            self.optimizer.step(noop_flag=flag, model_params=self._copies)
        elif not bool(skip):
            self.optimizer.step()
        for t in self.masters.values():
            t.grad = None
        self.step += 1
        state = self.scaler_states[loss_id]
        return {"overflow": skip,
                "loss_scale": state.loss_scale,
                "pinned_at_floor": self.scaler.pinned_at_floor(state)}

    @torch.no_grad()
    def apply_gradients_multi(self,
                              grads_list: Sequence[Sequence[torch.Tensor]],
                              loss_ids: Optional[Sequence[int]] = None,
                              reduce_fn: Optional[Callable] = None
                              ) -> Dict[str, Any]:
        """One optimizer fed by several backwards: ``grads_list[i]``
        (still scaled, zeros where a loss does not reach a parameter;
        reduced by ``reduce_fn`` first where given) is unscaled by scaler
        ``loss_ids[i]`` at the scale it was scaled with, checked, and that
        scaler updated; the unscaled gradients sum, and the step is
        skipped when any backward overflowed.  Returns ``overflow`` and
        per-scaler tuples ``loss_scale`` and ``pinned_at_floor``."""
        if loss_ids is None:
            loss_ids = list(range(len(grads_list)))
        if len(loss_ids) != len(grads_list):
            raise ValueError("loss_ids and grads_list length mismatch")
        if reduce_fn is not None:
            grads_list = [reduce_fn(g) for g in grads_list]
        if not self.properties.enabled:
            total = [torch.stack(gs).sum(0).float()
                     for gs in zip(*grads_list)]
            info = self.step_if(total, None)
            dev = self.step.device
            n = len(self.scaler_states)
            return {"overflow": info["overflow"],
                    "loss_scale": (torch.ones((), device=dev),) * n,
                    "pinned_at_floor": (torch.zeros(
                        (), dtype=torch.bool, device=dev),) * n}
        # every loss was scaled at entry: unscale against the entry states
        entry = list(self.scaler_states)
        total, any_overflow = None, None
        for grads, lid in zip(grads_list, loss_ids):
            self._check_count(grads)
            unscaled, flag = self.scaler.unscale(grads, entry[lid])
            overflow = self.update_scaler(lid, flag == 0)
            if total is None:
                total = unscaled
            else:
                torch._foreach_add_(total, unscaled)
            any_overflow = overflow if any_overflow is None \
                else any_overflow | overflow
        self.step_if(total, any_overflow)
        return {"overflow": any_overflow,
                "loss_scale": tuple(s.loss_scale
                                    for s in self.scaler_states),
                "pinned_at_floor": tuple(self.scaler.pinned_at_floor(s)
                                         for s in self.scaler_states)}


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
               num_losses: int = 1, device: DeviceLike = None) -> Amp:
    """Bind ``model`` (fp32 parameters) and ``optimizer`` (built over
    them, e.g. :class:`~apex_tpu_torch.optimizers.FusedAdam`, or any
    ``torch.optim`` optimizer) to an opt level and overrides: casts the
    model in place, makes the fp32 masters and moves the optimizer onto
    them.  The model must lie on ``device`` (the card by default;
    ``device="cpu"`` runs the plain versions).  ``opt_level`` defaults to
    ``"O1"``, as the JAX package's does; ``num_losses`` keeps one dynamic
    scaler per loss.  The result becomes
    :func:`apex_tpu_torch.amp.handle.active_amp`."""
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
    a = Amp(model, optimizer, props, scaler, keep_fp32_filter, num_losses)
    from apex_tpu_torch.amp import handle as handle_lib
    handle_lib._set_active_amp(a)
    return a


def _split_batch(tree: Any, n: int) -> List[Any]:
    """``tree``'s tensors cut along their leading dimension into ``n``
    micro-batches (the JAX package's ``(N, B / N)`` reshape)."""
    leaves, spec = pytree.tree_flatten(tree)
    parts = []
    for x in leaves:
        if not (isinstance(x, torch.Tensor) and x.dim() > 0
                and x.shape[0] % n == 0):
            shape = tuple(x.shape) if isinstance(x, torch.Tensor) else ()
            raise ValueError(
                f"accum_steps={n}: every batch argument leaf must have a "
                f"leading dim divisible by it; got shape {shape} (broadcast "
                "non-batched extras inside loss_fn instead of passing them "
                "as batch args)")
        parts.append(x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
                     .unbind(0))
    return [pytree.tree_unflatten([p[i] for p in parts], spec)
            for i in range(n)]


def make_train_step(amp: Amp, model: nn.Module, loss_fn: Callable,
                    axis_name=None, reduce_fn: Optional[Callable] = None,
                    accum_steps: Optional[int] = None) -> Callable:
    """``step(*batch) -> {"loss", "overflow", "loss_scale",
    "pinned_at_floor"}`` (device tensors): ``loss_fn(model, *batch)`` at
    compute precision, its fp32 loss scaled, the backward, then
    :meth:`Amp.apply_gradients`.  ``model`` is the one ``amp`` was
    initialized with.  The step makes no host sync.

    Data parallelism, as the JAX package resolves it: ``reduce_fn``
    (e.g. ``DistributedDataParallel(...).reduce``) reduces the scaled
    gradients before the unscale; ``axis_name`` (``"data"`` or a
    ``ProcessGroup``) without ``reduce_fn`` is a mean over the group
    (:func:`~apex_tpu_torch.parallel.reduce_gradients` with the default
    knobs); ``reduce_fn`` without ``axis_name`` takes its owner's
    ``axis_name``.  The loss returned is this rank's.

    ``accum_steps=N`` (> 1): every batch tensor's leading dimension splits
    into N micro-batches (``ValueError`` when it does not divide); each
    micro-batch's gradients are unscaled onto fp32 accumulators (one K10
    launch, ``acc = (1 / scale) * g + acc``: the stashed path of
    :meth:`Amp.apply_gradients`), which are divided by N, reduced once
    (``reduce_fn`` / ``axis_name``), checked once (K15 over the whole
    tree: an inf of any micro-batch, or of any rank, persists through the
    adds and the sum) and applied once, so the step is the large-batch
    mean-loss step; the returned loss is the mean of the micro-batch
    losses.  With a power-of-two scale (a dynamic one always is)
    unscaling before the sum gives the bits of unscaling after it."""
    if model is not amp.model:
        raise ValueError("make_train_step: model is not the one amp was "
                         "initialized with")
    if accum_steps is not None and int(accum_steps) < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if axis_name is None and reduce_fn is not None:
        axis_name = getattr(getattr(reduce_fn, "__self__", None),
                            "axis_name", None)
    if axis_name is not None and reduce_fn is None:
        from apex_tpu_torch.parallel.distributed import reduce_gradients

        def reduce_fn(grads):
            return reduce_gradients(grads, axis_name)

    def backward(batch):
        with torch.enable_grad():
            loss = amp.run(loss_fn, model, *batch)
            grads = torch.autograd.grad(amp.scale_loss(loss), amp.params)
        return loss.detach(), grads

    if accum_steps is None or int(accum_steps) == 1:
        def step(*batch) -> Dict[str, torch.Tensor]:
            loss, grads = backward(batch)
            info = amp.apply_gradients(grads, reduce_fn=reduce_fn)
            return {"loss": loss, **info}

        return step

    n = int(accum_steps)

    def accum_step(*batch) -> Dict[str, torch.Tensor]:
        micro = _split_batch(tuple(batch), n)
        acc = amp.accumulators()
        torch._foreach_zero_(acc)
        enabled = amp.properties.enabled
        losses = []
        for mb in micro:
            loss, grads = backward(mb)
            if enabled:
                with torch.no_grad():
                    amp.scaler.unscale_with_stashed(
                        grads, acc, amp.scaler_state, out=acc)
            else:
                amp.accumulate(grads, acc)
            losses.append(loss)
            del grads
        # the mean-loss step; JAX divides outside any kernel too
        torch._foreach_div_(acc, float(n))
        total = acc
        if reduce_fn is not None:
            with torch.no_grad():
                total = list(reduce_fn(acc))
        overflow = None
        if enabled:
            overflow = amp.update_scaler(0, all_finite(total))
        grads = amp.grad_buffers()
        if grads is not total:
            # kept buffers in the masters' dtype (bf16 under O3)
            torch._foreach_copy_(grads, total)
        info = amp.step_if(grads, overflow)
        return {"loss": torch.stack(losses).mean(), **info}

    return accum_step
