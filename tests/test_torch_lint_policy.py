"""The port's ``constant-capture`` and ``policy`` passes and its
``amp.audit`` (``apex_tpu_torch.analysis.constants``, ``.policy``,
``apex_tpu_torch.amp.audit``) held against the JAX package's, as
``tests/l0/test_graph_lint.py`` and ``tests/l0/test_policy_audit.py``
hold JAX's.

Each case seeds the same bug class in a JAX function and in its torch
counterpart, on the same inputs made from one numpy seed, and requires
the same finding codes, severities and dtypes: verdicts, not text.  The
port's subject is one eager call (``analysis.capture``), JAX's the
lowered program.  The four model families' O1 forwards run at the sizes
of ``tools/policy_audit.CASES``, with JAX's weights carried across by
``apex_tpu_torch.convert``.
"""

import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from apex_tpu import amp as jamp
from apex_tpu import analysis as janalysis
from apex_tpu.amp.audit import BLACKLIST_POINTWISE as JAX_BLACKLIST
from apex_tpu_torch import amp, analysis
from apex_tpu_torch.amp import ops as amp_ops
from apex_tpu_torch.optimizers import FusedAdam

REPO = Path(__file__).resolve().parents[1]


def _codes(findings):
    return sorted((f.severity, f.op, f.dtype) for f in findings)


def _verdict(report):
    return sorted((v["op"], v["dtype"]) for v in report["violations"])


def _pair(shape, seed=0, dtype=np.float32):
    x = np.random.default_rng(seed).standard_normal(shape).astype(dtype)
    return jnp.asarray(x), torch.from_numpy(x)


# -- constant-capture (tests/l0/test_graph_lint.py:298-331) --------------------

def _both_constant_capture(jfn, tfn, jargs, targs):
    theirs = janalysis.analyze(jfn, *jargs, passes=("constant-capture",),
                               compile=False)
    mine = analysis.analyze(tfn, *targs, passes=("constant-capture",))
    assert mine.ok == theirs.ok
    assert _codes(mine.findings) == _codes(theirs.findings)
    return mine, theirs


def test_a_closed_over_weight_fires_as_in_jax():
    jbig, tbig = _pair((512, 640))
    jx, tx = _pair((4, 512), seed=1)
    mine, theirs = _both_constant_capture(lambda x: x @ jbig,
                                          lambda x: x @ tbig, (jx,), (tx,))
    assert not mine.ok
    err, = mine.errors
    assert err.bytes == theirs.errors[0].bytes == 512 * 640 * 4
    assert err.dtype == "f32" and err.op == "constant"


def test_splat_and_small_tensors_are_quiet_as_in_jax():
    jsmall, tsmall = _pair((8, 8), seed=1)
    jz, tz = jnp.zeros((512, 640)), torch.zeros(512, 640)
    jx, tx = _pair((4, 512), seed=2)
    mine, _ = _both_constant_capture(
        lambda x: (x @ jz) * jsmall.sum(),
        lambda x: (x @ tz) * tsmall.sum(), (jx,), (tx,))
    assert mine.ok and not mine.findings


def test_a_weight_passed_as_an_argument_is_quiet_as_in_jax():
    jbig, tbig = _pair((512, 640))
    jx, tx = _pair((4, 512), seed=1)
    mine, _ = _both_constant_capture(lambda x, w: x @ w,
                                     lambda x, w: x @ w, (jx, jbig),
                                     (tx, tbig))
    assert mine.ok and not mine.findings


def test_a_weight_held_as_a_parameter_is_quiet():
    """The port's counterpart of a parameter passed in JAX's tree: an
    ``nn.Linear``'s weight, the module called directly, through a bound
    method, or from a closure that holds the module."""
    lin = torch.nn.Linear(512, 640)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 512)).astype(np.float32))
    for fn in (lin, lin.forward, lambda t: lin(t) * 2):
        rep = analysis.analyze(fn, x, passes=("constant-capture",))
        assert rep.ok and not rep.findings
    # the same weight as a raw attribute of a module escapes its state
    holder = torch.nn.Module()
    holder.w = lin.weight.detach().clone()
    rep = analysis.analyze(lambda t: t @ holder.w.T, x,
                           passes=("constant-capture",))
    assert [f.op for f in rep.errors] == ["constant"]


def test_default_passes_are_jaxs_restricted_to_the_registered():
    from apex_tpu.analysis import core as jcore
    assert analysis.DEFAULT_PASSES == tuple(
        p for p in jcore.DEFAULT_PASSES if p in analysis.PASSES) == (
        "collectives", "constant-capture")
    for name in ("constant-capture", "policy", "memory", "cost", "syncs"):
        assert name in analysis.PASSES
    assert "policy" not in analysis.DEFAULT_PASSES


# -- policy: the pointwise pins (tests/l0/test_policy_audit.py) ----------------

POINTWISE = {
    "exp": (jnp.exp, torch.exp), "expm1": (jnp.expm1, torch.expm1),
    "log": (jnp.log, torch.log), "log1p": (jnp.log1p, torch.log1p),
    "log2": (jnp.log2, torch.log2), "log10": (jnp.log10, torch.log10),
    "exp2": (jnp.exp2, torch.exp2), "sqrt": (jnp.sqrt, torch.sqrt),
    "rsqrt": (jax.lax.rsqrt, torch.rsqrt),
    "pow_float": (lambda x: x ** 2.5, lambda x: x ** 2.5),
    "pow_int": (lambda x: x ** 2, lambda x: x ** 2),
    "pow_tensor": (lambda x: x ** x, lambda x: x ** x),
    "sin": (jnp.sin, torch.sin), "cos": (jnp.cos, torch.cos),
    "tan": (jnp.tan, torch.tan), "sinh": (jnp.sinh, torch.sinh),
    "cosh": (jnp.cosh, torch.cosh), "atan": (jnp.arctan, torch.atan),
    "asin": (jnp.arcsin, torch.asin), "acos": (jnp.arccos, torch.acos),
}
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "f16": (jnp.float16, torch.float16),
          "f32": (jnp.float32, torch.float32)}


def _both_audits(jfn, tfn, x, jdt, tdt):
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x).to(tdt)
    return jamp.audit(jfn, jx), amp.audit(tfn, tx)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("op", sorted(POINTWISE))
def test_pointwise_verdicts_equal_jaxs(op, dtype):
    """The FP32-list pointwise ops with a 16-bit result are violations
    under JAX's opcode; in fp32 they are clean; ``x ** 2`` is JAX's
    ``integer_pow`` (multiplies) and clean in both."""
    x = np.random.default_rng(0).uniform(0.1, 0.9, (4, 8)).astype(
        np.float32)
    theirs, mine = _both_audits(*POINTWISE[op], x, *DTYPES[dtype])
    assert _verdict(mine) == _verdict(theirs)
    assert mine["ok"] is theirs["ok"] is (dtype == "f32" or op == "pow_int")
    assert amp.audit.__module__ == "apex_tpu_torch.analysis.policy"
    from apex_tpu_torch.amp.audit import BLACKLIST_POINTWISE
    assert BLACKLIST_POINTWISE == JAX_BLACKLIST
    for v in mine["violations"]:
        assert v["category"] == JAX_BLACKLIST[v["op"]]


#: fused aten ops that compute an FP32-list function inside, each beside
#: the JAX function of the same name (flax's norms for the norms)
FUSED = {
    "softmax": (lambda x: jax.nn.softmax(x, axis=-1),
                lambda x: F.softmax(x, dim=-1)),
    "log_softmax": (lambda x: jax.nn.log_softmax(x, axis=-1),
                    lambda x: F.log_softmax(x, dim=-1)),
    "logsumexp": (lambda x: jax.nn.logsumexp(x, axis=-1),
                  lambda x: torch.logsumexp(x, dim=-1)),
    "softplus": (jax.nn.softplus, F.softplus),
    "std": (lambda x: jnp.std(x, axis=-1),
            lambda x: torch.std(x, dim=-1, correction=0)),
    "var": (lambda x: jnp.var(x, axis=-1),
            lambda x: torch.var(x, dim=-1, correction=0)),
    "norm": (lambda x: jnp.linalg.norm(x, axis=-1),
             lambda x: torch.linalg.vector_norm(x, dim=-1)),
    "layer_norm": (lambda x: fnn.LayerNorm(use_scale=False,
                                           use_bias=False).apply({}, x),
                   lambda x: F.layer_norm(x, x.shape[-1:])),
    "group_norm": (lambda x: fnn.GroupNorm(
        num_groups=2, use_scale=False, use_bias=False).apply(
            {}, x.reshape(2, 2, 8)),
        lambda x: F.group_norm(x.reshape(2, 2, 8).transpose(1, 2), 2)),
    "batch_norm": (lambda x: fnn.BatchNorm(
        use_running_average=False, use_scale=False,
        use_bias=False).apply({"batch_stats": {
            "mean": jnp.zeros(8), "var": jnp.ones(8)}}, x,
            mutable=["batch_stats"])[0],
        lambda x: F.batch_norm(x, None, None, training=True)),
}


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("fused", sorted(FUSED))
def test_fused_op_verdicts_equal_jaxs(fused, dtype):
    """``aten._softmax`` with a bf16 result is flagged as raw
    ``jax.nn.softmax`` on bf16 is (``exponential``); the norms keep their
    statistics in fp32 in both packages and stay quiet."""
    x = np.random.default_rng(3).standard_normal((4, 8)).astype(np.float32)
    theirs, mine = _both_audits(*FUSED[fused], x, *DTYPES[dtype])
    assert _verdict(mine) == _verdict(theirs)
    assert mine["ok"] is theirs["ok"]


@pytest.mark.parametrize("fn", [torch.tanh, torch.sigmoid, torch.erf,
                                F.gelu, F.silu],
                         ids=["tanh", "sigmoid", "erf", "gelu", "silu"])
def test_half_safe_activations_are_not_flagged(fn):
    """tanh / logistic / erf stay in the autocast dtype in the reference
    (JAX pins them on crafted StableHLO, beside)."""
    txt = ("%0 = stablehlo.tanh %a : tensor<8xbf16>\n"
           "%1 = stablehlo.logistic %b : tensor<8xbf16>\n"
           "%2 = chlo.erf %c : tensor<8xbf16>\n")
    assert jamp.audit_text(txt)["ok"]
    rep = amp.audit(fn, torch.ones(8, dtype=torch.bfloat16))
    assert rep["ok"] and not rep["violations"]


def test_reductions_accumulate_in_fp32_and_stay_quiet():
    """``sum`` / ``mean`` / ``cumsum`` of bf16 accumulate in fp32 by
    torch's contract, as jnp's do; JAX's raw bf16 ``lax.reduce`` has no
    aten counterpart (ROADMAP Queue 3 Standing)."""
    x = np.ones((8, 4), np.float32)
    for jfn, tfn in ((lambda t: t.sum(0), lambda t: t.sum(0)),
                     (lambda t: t.mean(0), lambda t: t.mean(0)),
                     (lambda t: jnp.cumsum(t, 0), lambda t: t.cumsum(0))):
        theirs, mine = _both_audits(jfn, tfn, x, *DTYPES["bf16"])
        assert mine["ok"] and theirs["ok"]


def test_info_counters():
    """One fp32 product and one bf16 convolution: one missed half cast;
    the kernels' launches are 0 on the CPU (the wrappers' plain
    versions), where JAX's crafted text counts one custom call."""
    txt = ("%0 = stablehlo.dot_general %a, %b : (tensor<4x8xf32>, "
           "tensor<8x4xf32>) -> tensor<4x4xf32>\n"
           "%1 = stablehlo.convolution(%x, %w) : (tensor<1x8x8x3xbf16>, "
           "tensor<3x3x3x8xbf16>) -> tensor<1x8x8x8xbf16>\n")
    theirs = jamp.audit_text(txt)
    x = torch.ones(1, 3, 8, 8, dtype=torch.bfloat16)
    w = torch.ones(8, 3, 3, 3, dtype=torch.bfloat16)
    mine = amp.audit(lambda a, b: (a @ b, F.conv2d(x, w)),
                     torch.ones(4, 8), torch.ones(8, 4))
    assert mine["ok"] and theirs["ok"]
    assert mine["fp32_matmul_count"] == theirs["fp32_matmul_count"] == 1
    assert mine["custom_call_count"] == 0
    assert amp.audit_records(()) == {"ok": True, "violations": [],
                                     "fp32_matmul_count": 0,
                                     "custom_call_count": 0}


def test_violation_aggregation_counts_equal_jaxs():
    x = np.full((4,), 0.5, np.float32)
    theirs, mine = _both_audits(
        lambda t: (jnp.exp(t), jnp.exp(t + 1), jnp.exp(t + 2)),
        lambda t: (torch.exp(t), torch.exp(t + 1), torch.exp(t + 2)),
        x, *DTYPES["bf16"])
    assert [(v["op"], v["count"]) for v in mine["violations"]] == \
        [(v["op"], v["count"]) for v in theirs["violations"]] == \
        [("exponential", 3)]
    text = amp.format_report(mine)
    assert "exponential" in text and "FAIL" in text


# -- policy: an escaping model is caught end to end -----------------------------

def test_raw_softmax_escape_is_flagged_as_in_jax():
    """A model calling raw softmax on bf16 activations bypasses the op
    layer: JAX's ``test_raw_jnp_softmax_escape_is_flagged`` in both."""
    def jescaped(w, x):
        h = jnp.matmul(x, w).astype(jnp.bfloat16)
        return jax.nn.softmax(h, axis=-1).astype(jnp.float32).sum()

    def tescaped(w, x):
        h = torch.matmul(x, w).to(torch.bfloat16)
        return torch.softmax(h, dim=-1).float().sum()

    theirs = jamp.audit(jescaped, jnp.ones((8, 8)), jnp.ones((4, 8)))
    mine = amp.audit(tescaped, torch.ones(8, 8), torch.ones(4, 8))
    assert not mine["ok"] and not theirs["ok"]
    assert ("exponential", "bf16") in _verdict(mine)
    assert _verdict(mine) == _verdict(theirs)
    # the same verdict through the pass API
    rep = analysis.analyze(tescaped, torch.ones(8, 8), torch.ones(4, 8),
                           passes=("policy",))
    assert [(f.severity, f.op, f.dtype) for f in rep.errors] == \
        [("error", "exponential", "bf16")]


def test_amp_ops_softmax_is_clean_as_in_jax():
    """The same model through the op layer under O1: softmax takes the
    FP32 list's cast, in both packages."""
    from apex_tpu.amp import ops as jops
    ja = jamp.initialize(opt_level="O1", verbosity=0)

    def jpolicied(w, x):
        return jops.softmax(jops.matmul(x, w), axis=-1).astype(
            jnp.float32).sum()

    holder = torch.nn.Linear(8, 8)
    ta = amp.initialize(holder, FusedAdam(holder.parameters(), lr=1e-3,
                                          device="cpu"),
                        opt_level="O1", device="cpu")

    def tpolicied(w, x):
        return amp_ops.softmax(amp_ops.matmul(x, w), axis=-1).float().sum()

    theirs = jamp.audit(lambda *a: ja.run(jpolicied, *a), jnp.ones((8, 8)),
                        jnp.ones((4, 8)))
    mine = amp.audit(lambda *a: ta.run(tpolicied, *a), torch.ones(8, 8),
                     torch.ones(4, 8))
    assert mine["ok"] and theirs["ok"], (mine, theirs)


# -- policy: the four families' O1 forwards (tools/policy_audit.CASES) ----------

def _jax_cases():
    sys.path.insert(0, str(REPO / "tools"))
    import policy_audit
    return policy_audit


def _o1(model):
    return amp.initialize(model, FusedAdam(model.parameters(), lr=1e-3,
                                           device="cpu"),
                          opt_level="O1", device="cpu")


def _port_case(family, jparams):
    from apex_tpu_torch import convert, models
    tree = jax.tree.map(np.asarray, jparams)
    if family == "mlp":
        model = convert.mlp_params_from_jax(tree, features=(32,),
                                            device="cpu", trainable=True)
        batch = (torch.ones(4, 28, 28, 1), torch.zeros(4, dtype=torch.long))

        def loss(m, x, y):
            return models.cross_entropy_loss(m(x), y)
    elif family == "resnet":
        from apex_tpu.models.resnet import ResNet as JaxResNet
        v = JaxResNet(stage_sizes=(1, 1), num_classes=10, width=8).init(
            jax.random.PRNGKey(0), jnp.ones((2, 32, 32, 3)), train=True)
        model = convert.resnet_params_from_jax(
            tree, jax.tree.map(np.asarray, v["batch_stats"]),
            models.ResNet, device="cpu", trainable=True,
            stage_sizes=(1, 1), num_classes=10, width=8)
        batch = (torch.ones(2, 32, 32, 3), torch.zeros(2, dtype=torch.long))

        def loss(m, x, y):
            return models.resnet_loss(m(x, train=True), y)
    elif family == "gpt":
        model = convert.params_from_jax(tree, models.gpt_tiny(),
                                        device="cpu", trainable=True)
        batch = (torch.zeros(2, 32, dtype=torch.long),)

        def loss(m, x):
            return models.lm_loss(m(x)[:, :-1], x[:, 1:])
    else:
        model = convert.bert_params_from_jax(tree, models.bert_tiny(),
                                             device="cpu", trainable=True)
        batch = (torch.zeros(2, 32, dtype=torch.long),
                 torch.zeros(2, 32, dtype=torch.long),
                 torch.zeros(2, dtype=torch.long), torch.ones(2, 32))

        def loss(m, ids, mlm_labels, nsp_labels, mlm_mask):
            mlm, nsp = m(ids)
            return models.pretraining_loss(mlm, nsp, mlm_labels, nsp_labels,
                                           mlm_mask)
    a = _o1(model)
    return (lambda *b: a.run(loss, model, *b)), batch


@pytest.mark.parametrize("family", ["mlp", "resnet", "gpt", "bert"])
def test_model_family_o1_forward_is_policy_clean_in_both(family):
    """JAX's ``test_model_family_o1_forward_is_policy_clean`` beside the
    port's O1 forward of the same model, weights carried across."""
    fn, args = _jax_cases().CASES[family]()
    theirs = jamp.audit(fn, *args)
    tfn, batch = _port_case(family, args[0])
    mine = amp.audit(tfn, *batch)
    assert theirs["ok"], (family, theirs["violations"])
    assert mine["ok"], (family, mine["violations"])
    assert mine["custom_call_count"] == 0
