"""apex_tpu_torch: the PyTorch / CUDA port of ``apex_tpu`` for NVIDIA
Hopper.

Serving GPT: :class:`~apex_tpu_torch.serve.ServeEngine` (continuous
batching over a paged KV cache) and solo
:func:`~apex_tpu_torch.models.generate.generate`, with weights brought
across from a JAX checkpoint by :func:`~apex_tpu_torch.convert.
params_from_jax`.  Training GPT and BERT: :mod:`apex_tpu_torch.amp`
(O0-O3, device-side loss scaling, ``make_train_step`` with gradient
accumulation) with :class:`~apex_tpu_torch.optimizers.FusedAdam` or
:class:`~apex_tpu_torch.optimizers.FusedLAMB`; the flat-buffer
:class:`~apex_tpu_torch.optimizers.FP16Optimizer`; the multi-tensor
surface (:mod:`apex_tpu_torch.multi_tensor_apply`,
:mod:`apex_tpu_torch.ops.multi_tensor`) and :mod:`apex_tpu_torch.
fp16_utils`.  Layer norm and flash attention (forward and backward, rope
inside), the Adam steps, the LAMB stages, the amp unscale, axpby and the
sums of squares run as hand-written CUDA kernels (``apex_tpu_torch/csrc``)
on the card and as their plain PyTorch versions on the CPU.  Data
parallelism across processes: :mod:`apex_tpu_torch.parallel`
(``multiproc``, ``DistributedDataParallel``, a synchronized
``SyncBatchNorm``) over ``torch.distributed``.  Entry points
default to the card and raise when there is none unless given
``device="cpu"``.
"""
