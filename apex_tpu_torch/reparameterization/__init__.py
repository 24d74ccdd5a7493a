"""apex_tpu_torch.reparameterization: weight normalization and the
generic reparameterization (``apex_tpu/reparameterization``), in a dict
form (nested dicts of tensors, as the JAX package's pytrees) and a module
form (forward-pre hooks on an ``nn.Module``, the reference's
mechanism)."""

from apex_tpu_torch.reparameterization.reparameterization import (
    G_SUFFIX,
    V_SUFFIX,
    Reparameterization,
    apply_reparameterization,
    default_filter,
    merge,
    remove_reparameterization,
    reparameterized_apply,
)
from apex_tpu_torch.reparameterization.weight_norm import (
    WeightNorm,
    apply_weight_norm,
    remove_weight_norm,
)

__all__ = [
    "Reparameterization", "apply_reparameterization",
    "remove_reparameterization", "merge", "reparameterized_apply",
    "default_filter", "G_SUFFIX", "V_SUFFIX",
    "WeightNorm", "apply_weight_norm", "remove_weight_norm",
]
