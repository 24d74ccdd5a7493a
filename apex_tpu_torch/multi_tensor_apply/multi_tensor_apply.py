"""The multi-tensor applier, as ``apex_tpu/multi_tensor_apply/
multi_tensor_apply.py``: a callable holding the chunk size, applied as
``multi_tensor_applier(op, tensor_lists, *args)``.

As in the JAX package there is no ``noop_flag_buffer`` argument: the ops
return their non-finite flag (one int32 on the device).  ``available`` is
always True: the kernels are built from the checkout's sources at their
first launch on the card, and the plain versions run on the CPU.
"""

from __future__ import annotations

from apex_tpu_torch.ops.multi_tensor import CHUNK_SIZE


class MultiTensorApply:
    available = True
    import_err = None

    def __init__(self, chunk_size: int = CHUNK_SIZE):
        self.chunk_size = int(chunk_size)

    def __call__(self, op, tensor_lists, *args, **kwargs):
        return op(self.chunk_size, tensor_lists, *args, **kwargs)


multi_tensor_applier = MultiTensorApply(CHUNK_SIZE)
