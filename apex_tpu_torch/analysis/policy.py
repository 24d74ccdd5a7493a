"""O1 policy lint over a capture's dispatched ops, as
``apex_tpu/analysis/policy.py`` over lowered StableHLO.

The reference's O1 patches the whole ``torch`` namespace, so any model is
policy-covered by construction.  The port's policy layer
(:mod:`apex_tpu_torch.amp.ops`) covers code that routes through it: a
model calling raw ``torch.softmax`` on bf16 escapes the cast tables.
This pass closes that gap as the JAX one does, over what the call ran:
FP32-list work (``amp/lists.py`` ``FP32_OPS``) whose result is 16-bit.

Each aten op is judged as JAX's walk judges the same function on the
same dtypes, and a violation carries JAX's StableHLO opcode
(:data:`BLACKLIST_POINTWISE`), so the two verdicts compare directly:

- the pointwise ops ``exp``, ``exp2``, ``expm1``, ``log``, ``log2``,
  ``log10``, ``log1p``, ``pow``, ``sqrt``, ``rsqrt`` and the trig set
  with a 16-bit result (``pow`` with a Python ``int`` exponent is JAX's
  ``integer_pow``, multiplies, and stays quiet);
- the fused ops that compute such a function inside: ``_softmax``
  (``exponential``), ``_log_softmax`` and ``logsumexp`` (``exponential``
  and ``log``), ``softplus`` (``exponential`` and ``log_plus_one``),
  ``std`` and the 2-norm (``sqrt``).  ``native_layer_norm``,
  ``native_batch_norm`` and ``native_group_norm`` compute their
  statistics in fp32 whatever their dtype, as flax's norms do: quiet.

Deliberately not flagged, as in JAX: ``tanh``, ``sigmoid``, ``erf`` and
the activations made of them (half-safe, as the reference lists leave
them); reductions (``sum``, ``mean``, ``cumsum`` accumulate in fp32 by
torch's contract, as jnp's do: JAX's raw 16-bit ``lax.reduce`` has no
aten counterpart).

Audit the FORWARD (the loss / model call under ``Amp.run``), not the
train step: the lists govern the ops a user writes, and a backward
legitimately works in the wire dtype.  So ``policy`` is opt-in, as in
JAX.  Two counters round out the report: ``fp32_matmul_count`` (``mm``,
``bmm``, ``addmm``, ``baddbmm``, ``convolution`` with an fp32 result
inside an O1 program: missed half casts, a performance smell) and
``custom_call_count`` (the hand-written kernels' launches, opaque to the
walk as Pallas kernels are to JAX's; they keep their statistics in fp32
by construction).

:func:`audit` / :func:`audit_records` / :func:`format_report` keep the
JAX report dict ``{ok, violations, fp32_matmul_count,
custom_call_count}``; a violation's ``first_line`` is the position (from
1) of its first op in the capture.  ``apex_tpu_torch.amp`` re-exports
them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

from apex_tpu_torch.analysis.capture import Record, capture, hlo_dtype
from apex_tpu_torch.analysis.core import PassContext, register_pass
from apex_tpu_torch.analysis.report import Finding

#: 16-bit element types a violation can execute in.
_HALF_DTYPES = ("bf16", "f16")

#: StableHLO opcode -> FP32_OPS-category label (JAX's table).
BLACKLIST_POINTWISE = {
    "exponential": "exp/softmax",
    "exponential_minus_one": "expm1",
    "log": "log/log_softmax",
    "log_plus_one": "log1p",
    "power": "pow",
    "sqrt": "norm-stats",
    "rsqrt": "norm-stats",
    "cosine": "trig",
    "sine": "trig",
    "tan": "trig",
    "acos": "trig",
    "asin": "trig",
    "atan": "trig",
    "cosh": "trig",
    "sinh": "trig",
}

#: aten op (in-place spellings included) -> the opcodes of JAX's walk of
#: the same function on the same dtypes
ATEN_OPCODES = {
    "aten.exp": ("exponential",), "aten.exp2": ("exponential",),
    "aten.expm1": ("exponential_minus_one",), "aten.log": ("log",),
    "aten.log2": ("log",), "aten.log10": ("log",),
    "aten.log1p": ("log_plus_one",), "aten.pow": ("power",),
    "aten.sqrt": ("sqrt",), "aten.rsqrt": ("rsqrt",),
    "aten.cos": ("cosine",), "aten.sin": ("sine",), "aten.tan": ("tan",),
    "aten.acos": ("acos",), "aten.asin": ("asin",), "aten.atan": ("atan",),
    "aten.cosh": ("cosh",), "aten.sinh": ("sinh",),
    "aten._softmax": ("exponential",),
    "aten._safe_softmax": ("exponential",),
    "aten._log_softmax": ("exponential", "log"),
    "aten.logsumexp": ("exponential", "log"),
    "aten.softplus": ("exponential", "log_plus_one"),
    "aten.std": ("sqrt",), "aten.std_mean": ("sqrt",),
    "aten.linalg_vector_norm": ("sqrt",), "aten.norm": ("sqrt",),
}

_MATMULS = frozenset(("aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm",
                      "aten.convolution"))
_NORMS = frozenset(("aten.linalg_vector_norm", "aten.norm"))


def _packet(name: str) -> str:
    """``aten.exp_.default`` -> ``aten.exp``."""
    return name.rsplit(".", 1)[0].rstrip("_")


def _opcodes(r: Record) -> Sequence[str]:
    packet = _packet(r.name)
    codes = ATEN_OPCODES.get(packet, ())
    if packet == "aten.pow" and len(r.in_shapes) == 1 and r.scalars \
            and type(r.scalars[-1]) is int:
        return ()          # JAX's integer_pow: multiplies
    if packet in _NORMS and r.scalars and r.scalars[0] != 2:
        return ()          # no square root outside the 2-norm
    return codes


def audit_records(records: Sequence[Record],
                  launches: Optional[Mapping[str, int]] = None) -> dict:
    """The policy-audit report dict of a capture's records (``launches``:
    its kernel launches by name)."""
    violations: Dict[tuple, dict] = {}
    fp32_matmuls = 0
    for r in records:
        packet = _packet(r.name)
        dtype = hlo_dtype(r.out_dtypes[0]) if r.out_dtypes else None
        if packet in _MATMULS:
            fp32_matmuls += dtype == "f32"
            continue
        if dtype not in _HALF_DTYPES:
            continue
        for op in _opcodes(r):
            rec = violations.setdefault((op, dtype), {
                "op": op, "dtype": dtype,
                "category": BLACKLIST_POINTWISE[op],
                "count": 0, "first_line": r.index + 1,
                "example": f"{r.name} -> {dtype} "
                           f"{list(r.out_shapes[0])}"[:200]})
            rec["count"] += 1
    out = sorted(violations.values(), key=lambda v: (-v["count"], v["op"]))
    return {"ok": not out, "violations": out,
            "fp32_matmul_count": fp32_matmuls,
            "custom_call_count": sum((launches or {}).values())}


def audit(fn: Callable[..., Any], *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under a capture and policy-audit
    what it dispatched.  ``fn`` should be the O1 forward (``Amp.run`` of
    the loss), not the train step (the module docstring).  Unlike JAX's,
    which lowers only, this runs ``fn``."""
    cap = capture(fn, *args, **kwargs)
    return audit_records(cap.records, cap.launches)


def format_report(report: dict) -> str:
    """Human-readable rendering of :func:`audit`'s dict."""
    lines = []
    if report["ok"]:
        lines.append("policy audit: OK — no FP32-list op executes in "
                     "16-bit")
    else:
        lines.append("policy audit: FAIL — FP32-list work executing in "
                     "16-bit:")
        for v in report["violations"]:
            lines.append(
                f"  {v['op']} [{v['category']}] in {v['dtype']} "
                f"x{v['count']} (first at op {v['first_line']}): "
                f"{v['example']}")
    lines.append(f"  info: {report['fp32_matmul_count']} fp32 "
                 "matmul/conv ops (missed half casts if this is O1), "
                 f"{report['custom_call_count']} opaque kernel launches "
                 "(the port's kernels keep stats in fp32)")
    return "\n".join(lines)


def policy_pass(ctx: PassContext) -> List[Finding]:
    """The audit as a lint pass: each violation class becomes an
    ``error`` finding; the matmul / launch counters an ``info``."""
    rep = audit_records(ctx.capture.records, ctx.capture.launches)
    findings = [
        Finding("policy", "error",
                f"FP32-list op {v['op']} [{v['category']}] executes in "
                f"{v['dtype']}",
                op=v["op"], dtype=v["dtype"], count=v["count"],
                lineno=v["first_line"], example=v["example"])
        for v in rep["violations"]]
    findings.append(Finding(
        "policy", "info",
        f"{rep['fp32_matmul_count']} fp32 matmul/conv op(s) (missed "
        f"half casts if this is O1), {rep['custom_call_count']} opaque "
        f"kernel launch(es)"))
    return findings


register_pass("policy", policy_pass)
