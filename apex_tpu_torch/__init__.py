"""apex_tpu_torch: the PyTorch / CUDA port of ``apex_tpu`` for NVIDIA
Hopper.

Two slices are ported.  Serving GPT:
:class:`~apex_tpu_torch.serve.ServeEngine` (continuous batching over a
paged KV cache) and solo :func:`~apex_tpu_torch.models.generate.generate`,
with weights brought across from a JAX checkpoint by
:func:`~apex_tpu_torch.convert.params_from_jax`.  Training GPT:
:mod:`apex_tpu_torch.amp` (O0-O3, device-side loss scaling,
``make_train_step``) with :class:`~apex_tpu_torch.optimizers.FusedAdam`.
Layer norm (forward and backward), flash attention (forward and
backward, rope inside), the Adam step and the amp unscale run as
hand-written CUDA kernels (``apex_tpu_torch/csrc``) on the card and as
their plain PyTorch versions on the CPU.  Entry points default to the card and raise
when there is none unless given ``device="cpu"``.
"""
