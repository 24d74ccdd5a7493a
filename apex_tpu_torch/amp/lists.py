"""Casting policy tables of amp O1 and O4, as ``apex_tpu/amp/lists.py``.

The same tables as the JAX package's, naming the ops of the port's
policy-aware op layer (:mod:`apex_tpu_torch.amp.ops`):

- ``HALF_OPS``: contractions (the matmul family, convolutions, linear
  layers), cast to the policy's half dtype;
- ``FP32_OPS``: pointwise transcendentals, reductions, softmax, norms and
  losses, cast to fp32;
- ``PROMOTE_OPS``: binary math, run in the widest floating input type;
- ``SEQUENCE_PROMOTE_OPS``: concatenate / stack of a mixed-dtype list;
- ``BANNED_OPS``: binary cross entropy on probabilities, which raises
  under a policy when any input is in the half dtype;
- ``FP8_OPS``: under an fp8 policy (O4) the contractions, the only ops
  whose two operands quantize to e4m3 (fp32 accumulation);
- ``FP8_DENY_OPS``: never quantized below the 16-bit tables' decision
  (``prelu``, a half op that is no contraction, and ``FP32_OPS``).

``torch.autocast`` is not used: its op lists are not these tables, so it
would compute another function.
"""

HALF_OPS = [
    # BLAS / matmul family (torch_overrides.py:7-26)
    "matmul", "dot", "einsum", "dot_general", "tensordot",
    # convolutions (functional_overrides.py:18-27)
    "conv", "conv_general_dilated", "conv_transpose",
    # linear layers
    "linear", "prelu",
]

FP32_OPS = [
    # transcendental pointwise (torch_overrides.py:29-56)
    "acos", "asin", "cosh", "erfinv", "exp", "expm1", "log", "log10",
    "log1p", "log2", "pow", "reciprocal", "rsqrt", "sinh", "tan",
    # reductions
    "cumprod", "cumsum", "sum", "prod", "mean", "var", "std", "norm",
    "logsumexp",
    # softmax / norms / losses (functional_overrides.py:29-65)
    "softmax", "log_softmax", "softmin", "layer_norm", "group_norm",
    "batch_norm", "cross_entropy", "nll_loss", "l1_loss", "mse_loss",
    "smooth_l1_loss", "kl_div", "poisson_nll_loss", "cosine_embedding_loss",
    "softplus",
]

PROMOTE_OPS = [
    # binary math / comparison (torch_overrides.py:75-97); the op layer
    # casts every floating input to the widest one first.
    "add", "div", "mul", "sub", "atan2", "equal", "greater", "less",
    "maximum", "minimum",
]

SEQUENCE_PROMOTE_OPS = ["concatenate", "stack"]  # torch_overrides.py:100-103

BANNED_OPS = ["binary_cross_entropy"]  # functional_overrides.py:67-77

FP8_OPS = [
    # the contraction family: the only ops whose operands quantize
    "matmul", "dot", "einsum", "dot_general", "tensordot", "linear",
    "conv", "conv_general_dilated", "conv_transpose",
]

FP8_DENY_OPS = [
    # a pointwise select among the half ops (quantizing its alpha would
    # pollute the weight class's amax history), and every fp32 op
    "prelu",
] + FP32_OPS

BANNED_MESSAGE = (
    "amp does not work out-of-the-box with binary_cross_entropy on "
    "probabilities: the op requires inputs in [0,1] that a 16-bit sigmoid "
    "cannot guarantee, and log(0) saturates. Use a *_with_logits loss "
    "(sigmoid folded into the loss, computed in fp32) instead, or wrap the "
    "call in apex_tpu_torch.amp.disable_casts() if you accept the risk. "
    "(Reference: apex/amp/lists/functional_overrides.py:67-77.)"
)
