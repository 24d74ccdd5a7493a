"""Optimization-level policy, as ``apex_tpu/amp/policy.py``: ``Properties``
and the ``O0``-``O4`` levels, with bf16 as the half dtype.

O1's ``cast_ops`` turns on the op layer of :mod:`apex_tpu_torch.amp.ops`;
O4 is O2's rig (fp32 masters, a bf16 model, a dynamic loss scale) with
that op layer on and its contractions quantized to fp8 under delayed
scaling (:mod:`apex_tpu_torch.quant.fp8`).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Union

import torch

#: accepted spelling of a dynamic loss scale
DYNAMIC = "dynamic"


def _parse_tristate(value: Union[None, bool, str],
                    name: str) -> Optional[bool]:
    """``None | bool | "True" | "False"`` (argparse-produced strings work
    unmodified, as in the reference)."""
    if value is None or isinstance(value, bool):
        return value
    if isinstance(value, str):
        if value == "True":
            return True
        if value == "False":
            return False
    raise ValueError(f"{name} must be None, a bool, or 'True'/'False'; "
                     f"got {value!r}")


def _parse_loss_scale(value: Union[None, float, int, str]
                      ) -> Union[None, float, str]:
    """A loss scale: a number or the string ``"dynamic"``."""
    if value is None or value == DYNAMIC:
        return value
    try:
        return float(value)
    except (TypeError, ValueError):
        raise ValueError(
            f"loss_scale must be a number or 'dynamic'; got {value!r}"
        ) from None


@dataclasses.dataclass(frozen=True)
class Properties:
    """Resolved mixed-precision options (the JAX package's
    ``Properties``).

    ``cast_model_dtype``: dtype the model params and compute are cast to
    (O0, O2, O3), or None to leave the model in fp32 (O1).
    ``cast_ops``: O1-style casting of individual ops (:mod:`.ops`).
    ``keep_batchnorm_fp32``: keep normalization params in fp32 when the
    model is cast.  ``master_weights``: keep fp32 master params and run
    the optimizer on them.  ``loss_scale``: a number or ``"dynamic"``.
    ``cast_model_outputs``: dtype model outputs are cast to (fp32 when
    None).  ``fp8``: O4's switch, the contractions of the op layer
    quantize their operands to fp8 at delayed per-tensor scales;
    ``fp8_dtype_fwd`` / ``fp8_dtype_bwd`` the forward (e4m3) and backward
    (e5m2) formats, set when ``fp8`` is; ``fp8_amax_history_len`` the
    amax window (at least 1); ``fp8_margin`` the power-of-two headroom
    of the derived scale."""

    enabled: bool = True
    opt_level: str = "O1"
    cast_model_dtype: Optional[torch.dtype] = None
    cast_ops: bool = True
    keep_batchnorm_fp32: Optional[bool] = None
    master_weights: Optional[bool] = None
    loss_scale: Union[float, str] = DYNAMIC
    half_dtype: torch.dtype = torch.bfloat16
    cast_model_outputs: Optional[torch.dtype] = None
    fp8: bool = False
    fp8_dtype_fwd: Optional[torch.dtype] = None
    fp8_dtype_bwd: Optional[torch.dtype] = None
    fp8_amax_history_len: int = 16
    fp8_margin: int = 0

    def __post_init__(self):
        object.__setattr__(
            self, "keep_batchnorm_fp32",
            _parse_tristate(self.keep_batchnorm_fp32, "keep_batchnorm_fp32"))
        object.__setattr__(self, "loss_scale",
                           _parse_loss_scale(self.loss_scale))
        if self.fp8:
            if self.fp8_dtype_fwd is None:
                object.__setattr__(self, "fp8_dtype_fwd",
                                   torch.float8_e4m3fn)
            if self.fp8_dtype_bwd is None:
                object.__setattr__(self, "fp8_dtype_bwd", torch.float8_e5m2)
            if self.fp8_amax_history_len < 1:
                raise ValueError(
                    f"fp8_amax_history_len must be >= 1; got "
                    f"{self.fp8_amax_history_len}")
        if self.cast_ops and self.cast_model_dtype is not None \
                and not self.fp8:
            warnings.warn(
                "O1-style op casting (cast_ops=True) together with a cast "
                "model dtype is unusual; O1 expects the model left in fp32.")
        if self.keep_batchnorm_fp32 and self.cast_model_dtype is None:
            warnings.warn("keep_batchnorm_fp32 has no effect when the model "
                          "is not cast.")

    @property
    def is_dynamic_loss_scale(self) -> bool:
        return self.loss_scale == DYNAMIC

    @property
    def use_master_weights(self) -> bool:
        """Whether fp32 master params are on under this policy."""
        if self.master_weights is not None:
            return bool(self.master_weights)
        return self.cast_model_dtype is not None \
            and self.cast_model_dtype != torch.float32

    def replace(self, **kw) -> "Properties":
        return dataclasses.replace(self, **kw)


def O0(half_dtype=torch.bfloat16) -> Properties:
    """Pure fp32."""
    return Properties(
        opt_level="O0", cast_model_dtype=torch.float32, cast_ops=False,
        keep_batchnorm_fp32=None, master_weights=False, loss_scale=1.0,
        half_dtype=half_dtype)


def O1(half_dtype=torch.bfloat16) -> Properties:
    """Policy-cast ops, fp32 model, dynamic scale."""
    return Properties(
        opt_level="O1", cast_model_dtype=None, cast_ops=True,
        keep_batchnorm_fp32=None, master_weights=None, loss_scale=DYNAMIC,
        half_dtype=half_dtype)


def O2(half_dtype=torch.bfloat16) -> Properties:
    """Half model + fp32 norm layers + fp32 masters + dynamic scale."""
    return Properties(
        opt_level="O2", cast_model_dtype=half_dtype, cast_ops=False,
        keep_batchnorm_fp32=True, master_weights=True, loss_scale=DYNAMIC,
        half_dtype=half_dtype)


def O3(half_dtype=torch.bfloat16) -> Properties:
    """Pure half."""
    return Properties(
        opt_level="O3", cast_model_dtype=half_dtype, cast_ops=False,
        keep_batchnorm_fp32=False, master_weights=False, loss_scale=1.0,
        half_dtype=half_dtype)


def O4(half_dtype=torch.bfloat16) -> Properties:
    """fp8 training: O2's rig (fp32 masters and norm layers, a dynamic
    loss scale, a half model) with the op layer's contractions quantized
    to fp8 at delayed per-tensor scales (e4m3 forward, e5m2 backward,
    fp32 accumulation); the ``Amp`` carries an ``Fp8TrainState`` beside
    the loss scaler."""
    return Properties(
        opt_level="O4", cast_model_dtype=half_dtype, cast_ops=True,
        keep_batchnorm_fp32=True, master_weights=True, loss_scale=DYNAMIC,
        half_dtype=half_dtype, fp8=True)


opt_levels = {"O0": O0, "O1": O1, "O2": O2, "O3": O3, "O4": O4}


def resolve(opt_level: str = "O1", half_dtype=torch.bfloat16,
            enabled: bool = True, **overrides) -> Properties:
    """Select an opt level, then apply explicit per-kwarg overrides (the
    reference's resolution order).  ``cast_model_dtype=False`` means "do
    not cast the model" on top of O2 / O3."""
    if opt_level not in opt_levels:
        raise ValueError(
            f"Unexpected optimization level {opt_level!r}; options are "
            "'O0', 'O1', 'O2', 'O3', 'O4' (the letter O, not zero; "
            "O4 = fp8 training with delayed scaling, see "
            "apex_tpu_torch.quant).")
    props = opt_levels[opt_level](half_dtype=half_dtype)
    overrides = {k: v for k, v in overrides.items() if v is not None}
    cast_override = overrides.pop("cast_model_dtype", None)
    if cast_override is False:
        props = props.replace(
            cast_model_dtype=None,
            keep_batchnorm_fp32=overrides.pop("keep_batchnorm_fp32", None))
    elif cast_override is not None:
        overrides["cast_model_dtype"] = cast_override
    return props.replace(enabled=enabled, **overrides)
