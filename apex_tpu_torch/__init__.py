"""apex_tpu_torch: the PyTorch / CUDA port of ``apex_tpu`` for NVIDIA
Hopper.

This slice serves GPT: :class:`~apex_tpu_torch.serve.ServeEngine`
(continuous batching over a paged KV cache) and solo
:func:`~apex_tpu_torch.models.generate.generate`, with weights brought
across from a JAX checkpoint by :func:`~apex_tpu_torch.convert.
params_from_jax`.  Layer norm and flash attention run as hand-written
CUDA kernels (``apex_tpu_torch/csrc``) on the card and as their plain
PyTorch versions on the CPU.  Entry points default to the card and raise
when there is none unless given ``device="cpu"``.
"""
