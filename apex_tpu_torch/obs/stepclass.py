"""Step classifiers over the torch profiler's trace: ONE bucket vocabulary
per loop kind, as ``apex_tpu/obs/stepclass.py``.

The JAX package buckets measured op time through classifiers built from
the compiled HLO text (instruction name -> bucket, from ``op_name``
metadata scopes and shape markers).  An eager PyTorch step has no
compiled program, so here the subject is the capture itself: each device
event keyed by :func:`apex_tpu_torch.obs.xplane.keyed_times` under the
host op that launched it (:class:`~apex_tpu_torch.obs.xplane.OpKey`:
the root range of the step, the ranges open at the launch on its
thread, the kernel's name).  A classifier decides a key's bucket from
those ranges, never from the kernel's name alone: a cuBLAS GEMM of the
forward and the same GEMM launched by the autograd thread carry one
name and land in ``fwd`` and ``bwd``.  On a host capture (the CPU) the
keys are the host ops' self times under their own ranges, so the same
classifiers run in the CPU tests.

Three classifiers, two vocabularies:

- :class:`TrainStepClassifier` — :data:`TRAIN_BUCKETS` (``fwd / bwd /
  optimizer / collectives / host_gap / other``): NCCL kernels and gloo /
  c10d ops -> ``collectives`` (checked FIRST, as JAX checks collective
  opcodes first); a launch under ``autograd::engine::evaluate_function:
  ...`` (the autograd engine's ranges, on its own thread on the card) or
  the step's :data:`AMP_BACKWARD` range -> ``bwd``; a range matching
  :data:`OPTIMIZER_SCOPES` (amp's :data:`AMP_APPLY` range, the unscale,
  ``Optimizer.step``, the named optimizers' ops) -> ``optimizer``;
  the step's :data:`AMP_FORWARD` range -> ``fwd``; else ``None``
  (``other``).  ``host_gap`` is never returned: it is the step wall less
  the attributed time, which the profiler computes;
- :class:`ServeStepClassifier` — :data:`DECODE_BUCKETS` over the serve
  engine's decode step (the base step, or a speculative round's verify;
  the draft's launches land in ``other``, as JAX's draft ops do);
- :class:`DecodeStepClassifier` — the same buckets over solo
  ``generate()``'s decode steps.

The decode buckets come from the named ranges of the decode path
(:data:`DECODE_RANGES`, opened through
:func:`apex_tpu_torch.utils.profiling.profile_range`, so they cost one
flag check outside a capture): the paged gather and the cache's fp32
read (``kv_read``), the pool writes with their quantization
(``kv_write``), the score chain of ``_attn_cached`` (``attention``),
``serve/sampling.py`` (``sampling``), the embedding gather and the
weight products with their biases (``param_read``); host <-> device
copies are ``host_sync``.  Precedence follows JAX's: ``host_sync``,
``kv_write``, ``kv_read`` (the cache read inside the attention range),
``attention``, ``sampling``, ``param_read``.

Classifiers are plain callables (``clf(key) -> bucket | None``) with a
``step_ops()`` container of the step's keys (membership by the step's
range: an eager step has no program whose ops could be listed), the
contract :func:`apex_tpu_torch.obs.xplane.bucket_op_times` consumes.

:data:`PROFILE_GROUPS` names the port's kernels (and the library
families) by fragments of their kernel names: :func:`kernel_group`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from apex_tpu_torch.obs.xplane import ROOT_PREFIX, OpKey

__all__ = [
    "TRAIN_BUCKETS", "DECODE_BUCKETS", "OPTIMIZER_SCOPES", "DECODE_RANGES",
    "AMP_FORWARD", "AMP_BACKWARD", "AMP_APPLY", "GENERATE_STEP",
    "PROFILE_GROUPS", "OTHER_GROUP", "kernel_group", "StepOps",
    "window_scope", "DRAFT_SCOPES",
    "DecodeStepClassifier", "ServeStepClassifier", "TrainStepClassifier",
]

#: the decode bucket vocabulary — MUST equal the JAX package's
#: (``apex_tpu.obs.stepclass.DECODE_BUCKETS``,
#: ``apex_tpu.analysis.decode_profile.BUCKETS``) and
#: :data:`apex_tpu_torch.analysis.profile_drift.DECODE_BUCKETS` (pinned
#: by test; the schema module stays stdlib only, so the tuple is
#: duplicated, not imported).
DECODE_BUCKETS = ("param_read", "kv_read", "kv_write", "attention",
                  "sampling", "host_sync", "other")

#: the pinned train-step vocabulary — MUST equal the JAX package's and
#: :data:`apex_tpu_torch.analysis.profile_drift.TRAIN_BUCKETS`.
#: ``host_gap`` is the derived wall-minus-attributed residual, never a
#: classification result.
TRAIN_BUCKETS = ("fwd", "bwd", "optimizer", "collectives", "host_gap",
                 "other")

#: range name fragments (lower case) of the optimizer and scaler update,
#: matched against the ranges a launch sits in (never a kernel's name):
#: amp's apply range, the unscale (amp's and PyTorch's), the
#: ``Optimizer.step#...`` range PyTorch records, the named optimizers'
#: ops.  JAX's ``cond`` (the overflow skip's ``lax.cond``) has no
#: counterpart: the port's skip is inside the apply range.
OPTIMIZER_SCOPES = ("optimizer", "unscale", "adam", "lamb", "sgd",
                    "apply_grad", "larc", "novograd")

#: the ranges of ``amp.make_train_step``'s step
AMP_FORWARD = "amp/forward"
AMP_BACKWARD = "amp/backward"
AMP_APPLY = "amp/apply_gradients"

#: the decode path's ranges, by bucket (module docstring)
DECODE_RANGES = {"kv_write": "decode/kv_write", "kv_read": "decode/kv_read",
                 "attention": "decode/attention",
                 "sampling": "decode/sampling",
                 "param_read": "decode/param_read"}
_DECODE_ORDER = ("kv_write", "kv_read", "attention", "sampling",
                 "param_read")

#: the range of one decode step of solo ``generate()``
GENERATE_STEP = "generate/decode_step"

#: the speculative draft's ranges: their launches land in ``other``
DRAFT_SCOPES = ("serve/spec_draft", "serve/spec_draft_prefill")

_COLLECTIVE_PREFIXES = ("gloo:", "nccl:", "c10d::", "record_param_comms")
#: host <-> device copies (the device's memcpy events) and host reads
_HOST_SYNC_PREFIXES = ("Memcpy HtoD", "Memcpy DtoH", "Memcpy HtoH",
                       "aten::_local_scalar_dense")

#: kernel-name fragments (lower case) of the port's kernels and the
#: library families, by group: the first group whose fragment a kernel's
#: name holds is its group (:func:`kernel_group`)
PROFILE_GROUPS = (("NCCL collectives", ("nccl",)),
                  ("conv1x1_bwd (K16)", ("conv1x1_bwd_kernel",
                                         "conv1x1_one_pass",
                                         "conv1x1_two_role")),
                  ("generic flash forward", ("fwd_simt",)),
                  ("generic flash dk / dv", ("dkdv_simt",)),
                  ("generic flash dq", ("dq_simt",)),
                  ("flash_attn_bwd_dq (K13)", ("flash_bwd_dq_sm90",)),
                  ("flash_attn_bwd_dkv (K14)", ("flash_bwd_dkv_sm90",)),
                  ("prologues (k^; q^ and k^)", ("flash_bwd_prologue",)),
                  ("finish pass (K4's dq planes)", ("flash_bwd_finish",)),
                  ("flash_attn_bwd (K4)", ("flash_bwd_fused",)),
                  ("flash_attn_fwd (K2)", ("flash_fwd",)),
                  ("layer_norm_bwd (K3)", ("ln_bwd",)),
                  ("layer_norm_fwd (K1)", ("ln_fwd",)),
                  ("adam_tree (K11)", ("adam_tree_kernel",)),
                  ("axpby (K10)", ("axpby_kernel",)),
                  ("sumsq_per_tensor (K12)", ("sumsq_per_leaf_kernel",)),
                  ("packed_adam (K5)", ("adam_kernel",)),
                  ("packed_scale (K6)", ("scale_kernel",)),
                  ("lamb_stage1 (K7)", ("lamb_stage1",)),
                  ("lamb_stage2 (K8)", ("lamb_stage2",)),
                  ("packed_sumsq (K9)", ("sumsq_kernel",)),
                  ("convolutions (cuDNN)", ("fprop", "dgrad", "wgrad",
                                            "implicit_convolve",
                                            "cudnn")),
                  ("matmuls (cuBLAS)", ("gemm", "xmma", "cutlass", "cublas",
                                        "sm90_", "nvjet")))
OTHER_GROUP = "other PyTorch kernels"


def kernel_group(name: str) -> str:
    """The :data:`PROFILE_GROUPS` group of a kernel's name, else
    :data:`OTHER_GROUP`."""
    low = name.lower()
    return next((g for g, frags in PROFILE_GROUPS
                 if any(f in low for f in frags)), OTHER_GROUP)


def window_scope(name: str) -> str:
    """The root range a continuous-profiler window named ``name`` opens
    around each step it captures (``contprof/<name>``)."""
    return f"{ROOT_PREFIX}{name}"


class StepOps:
    """The keys of one step: those whose root is the step's range, or
    that were launched inside it on its own thread.  A container (``key
    in ops``), not a list: an eager step's ops are known only from a
    capture."""

    def __init__(self, scope: str):
        self.scope = scope

    def __contains__(self, key) -> bool:
        return isinstance(key, OpKey) and (
            key.root == self.scope or self.scope in key.scopes)

    def __repr__(self) -> str:
        return f"StepOps({self.scope!r})"


class _Classifier:
    """A memoized ``key -> bucket | None`` over one step's range."""

    def __init__(self, scope: str):
        self.scope = scope
        self.buckets: Dict[OpKey, Optional[str]] = {}

    def step_ops(self) -> StepOps:
        return StepOps(self.scope)

    def __call__(self, key) -> Optional[str]:
        if not isinstance(key, OpKey):
            return None
        if key not in self.buckets:
            self.buckets[key] = self._bucket(key)
        return self.buckets[key]

    def _bucket(self, key: OpKey) -> Optional[str]:
        raise NotImplementedError


def _decode_bucket(key: OpKey, excluded: Tuple[str, ...] = ()
                   ) -> Optional[str]:
    if any(s in excluded for s in key.scopes):
        return None
    if any(n.startswith(_HOST_SYNC_PREFIXES)
           for n in key.scopes + (key.name,)):
        return "host_sync"
    for bucket in _DECODE_ORDER:
        if DECODE_RANGES[bucket] in key.scopes:
            return bucket
    return None


class DecodeStepClassifier(_Classifier):
    """key -> DECODE bucket for solo ``generate()``'s decode steps: the
    keys inside :data:`GENERATE_STEP` ranges (the full prefill is not a
    step).  Same buckets and precedence as the serve classifier."""

    def __init__(self):
        super().__init__(GENERATE_STEP)

    def _bucket(self, key: OpKey) -> Optional[str]:
        return _decode_bucket(key)


class ServeStepClassifier(_Classifier):
    """key -> DECODE bucket for a serve engine's step: the keys under
    the engine's window range (:func:`window_scope` of its trace name),
    which the engine's profiler opens around each captured step.  The
    speculative draft's launches (:data:`DRAFT_SCOPES`) land in
    ``other``; the verify round's in the buckets."""

    def __init__(self, scope: str = window_scope("engine")):
        super().__init__(scope)

    def _bucket(self, key: OpKey) -> Optional[str]:
        return _decode_bucket(key, DRAFT_SCOPES)


def _is_collective(name: str) -> bool:
    return "nccl" in name.lower() or name.startswith(_COLLECTIVE_PREFIXES)


class TrainStepClassifier(_Classifier):
    """key -> TRAIN bucket for a train step, from the ranges the launch
    sits in (the module docstring gives the rule and its precedence)."""

    def __init__(self, scope: str = window_scope("train")):
        super().__init__(scope)

    def _bucket(self, key: OpKey) -> Optional[str]:
        names = key.scopes + (key.name,)
        if any(_is_collective(n) for n in names):
            return "collectives"
        if AMP_BACKWARD in key.scopes or any(
                n.startswith("autograd::engine::evaluate_function")
                for n in names):
            return "bwd"
        # the ranges only: a kernel's name is no scope (an elementwise
        # kernel's ``{lambda(int)#1}`` would read as "lamb")
        if any(m in n.lower() for n in key.scopes
               for m in OPTIMIZER_SCOPES):
            return "optimizer"
        if AMP_FORWARD in key.scopes:
            return "fwd"
        return None
