"""The port's ``flash_attention_mh`` (K17 / K18's plain versions, and on
the CPU the two-pass route's) against the JAX package's
``flash_attention_mh`` (``apex_tpu/ops/pallas/experimental/flash_mh.py``,
its Pallas kernels in interpret mode), in fp32.

Tolerance: ``rtol = atol = 2e-5`` on o, lse and the gradients of q, k and
v (with a cotangent on the lse too), the JAX test's CPU tolerance
(``tests/l0/test_flash_mh.py``): interpret mode and the port's plain
versions both compute exact fp32, in other summation orders.  Covered:
causal and not, a key mask, a ragged L (JAX pads and biases, the port
masks), head widths 64, 128 and 40 (not a multiple of 16: the kernels'
zero-padded case), both routes of the port's partials gate
(``APEX_TPU_FLASH_FUSED_BWD_MAX_BYTES``) against JAX's fused route (its
own fallback route raises a ``TypeError`` in the JAX package), and JAX's
order of the scale (q times the scale in q's dtype before the kernel; dq
times it after).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.pallas.experimental.flash_mh import (
    flash_attention_mh as jax_flash_mh)
from apex_tpu_torch.ops.cuda import (
    flash_mh_bwd_ref,
    flash_mh_fwd_ref,
    mh_fused_bwd,
    mh_partials_bytes,
)
from apex_tpu_torch.ops.experimental import flash_attention_mh

TOL = 2e-5
BUDGET = "APEX_TPU_FLASH_FUSED_BWD_MAX_BYTES"


def _inputs(b, l, h, d, seed=0, masked=False):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.standard_normal((b, l, h, d)).astype(np.float32)
                   for _ in range(4))
    dlse = rng.standard_normal((b, l, h)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.rand(b, l) > 0.3
        mask[:, 0] = True
    return q, k, v, do, dlse, mask


def _jax(q, k, v, do, dlse, mask, causal):
    km = None if mask is None else jnp.asarray(mask)

    def f(q, k, v):
        return jax_flash_mh(q, k, v, causal=causal, kv_mask=km,
                            block_q=128, block_k=128, return_lse=True)

    (o, lse), vjp = jax.vjp(f, *(jnp.asarray(t) for t in (q, k, v)))
    grads = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    return [np.asarray(t) for t in (o, lse, *grads)]


def _port(q, k, v, do, dlse, mask, causal):
    tq, tk, tv = (torch.from_numpy(t.copy()).requires_grad_(True)
                  for t in (q, k, v))
    km = None if mask is None else torch.from_numpy(mask)
    o, lse = flash_attention_mh(tq, tk, tv, causal=causal, kv_mask=km,
                                return_lse=True)
    torch.autograd.backward((o, lse), (torch.from_numpy(do),
                                       torch.from_numpy(dlse)))
    return [t.detach().numpy() for t in (o, lse, tq.grad, tk.grad,
                                         tv.grad)]


CASES = {
    "causal": dict(shape=(2, 256, 4, 64), causal=True),
    "full": dict(shape=(2, 256, 4, 64), causal=False),
    "masked": dict(shape=(2, 256, 4, 64), causal=False, masked=True),
    "ragged_causal": dict(shape=(2, 200, 2, 64), causal=True),
    "ragged_masked": dict(shape=(2, 200, 2, 64), causal=False,
                          masked=True),
    "d128": dict(shape=(1, 256, 2, 128), causal=True),
    "d40_masked": dict(shape=(1, 136, 3, 40), causal=False, masked=True),
}


@pytest.mark.parametrize("route", ["fused", "two_pass"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax(case, route, monkeypatch):
    c = CASES[case]
    monkeypatch.delenv(BUDGET, raising=False)
    args = _inputs(*c["shape"], seed=len(case), masked=c.get("masked",
                                                             False))
    # JAX's fused route is the oracle of both: its own fallback raises
    # (``_mh_bwd_rule`` calls ``flash_attention._flash_bwd`` without the
    # rope tables that function now takes; ROADMAP.md Queue 3)
    want = _jax(*args, c["causal"])
    if route == "two_pass":
        monkeypatch.setenv(BUDGET, "0")
    got = _port(*args, c["causal"])
    for name, g, w in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                   err_msg=f"{case} {route} {name}")


def test_the_gate_measures_the_kernels_planes(monkeypatch):
    """K18's planes are one (B, L, H, D) fp32 plane per 64-key tile; the
    gate compares them with the budget, read on every call."""
    q = torch.zeros(8, 2048, 12, 64)
    assert mh_partials_bytes(8, 2048, 12, 64) == 32 * 8 * 2048 * 768 * 4
    monkeypatch.delenv(BUDGET, raising=False)
    assert not mh_fused_bwd(q)                  # 1.61 GB > 1 GiB
    assert mh_fused_bwd(torch.zeros(32, 512, 16, 64))
    monkeypatch.setenv(BUDGET, str(1 << 40))
    assert mh_fused_bwd(q)
    monkeypatch.setenv(BUDGET, "0")
    assert not mh_fused_bwd(torch.zeros(1, 64, 1, 8))


def test_the_scale_is_applied_in_qs_dtype_as_jax():
    """bf16 at D 128 (a scale that is not a power of two): the plain
    versions multiply q by the bf16-rounded scale in bf16 before the
    product and dq after, as JAX does; scaling the fp32 scores instead
    is another function."""
    q, k, v, do, dlse, _ = _inputs(1, 64, 2, 128, seed=3)
    tq, tk, tv, tdo = (torch.from_numpy(t).to(torch.bfloat16)
                       for t in (q, k, v, do))
    scale = 128 ** -0.5
    o, lse = flash_mh_fwd_ref(tq, tk, tv, causal=True, scale=scale)
    s_b = torch.tensor(scale, dtype=torch.bfloat16)
    qf = (tq * s_b).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, tk.float())
    s = s.masked_fill(~torch.ones(64, 64, dtype=torch.bool).tril(),
                      -1e30)
    want_lse = torch.logsumexp(s, -1).permute(0, 2, 1)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5)
    other = torch.einsum("bqhd,bkhd->bhqk", tq.float(), tk.float()) * scale
    other = torch.logsumexp(other.masked_fill(
        ~torch.ones(64, 64, dtype=torch.bool).tril(), -1e30), -1)
    assert not torch.allclose(lse, other.permute(0, 2, 1), rtol=0,
                              atol=1e-6)
    dq, dk, dv = flash_mh_bwd_ref(tq, tk, tv, o, lse, tdo,
                                  dlse=torch.from_numpy(dlse), causal=True,
                                  scale=scale)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    # dq is the unscaled one times the bf16 scale, in bf16
    dq1, _, _ = flash_mh_bwd_ref(tq * s_b, tk, tv, o, lse, tdo,
                                 dlse=torch.from_numpy(dlse), causal=True,
                                 scale=1.0)
    assert torch.equal(dq, dq1 * s_b)


def test_rejects_what_jax_rejects():
    q = torch.zeros(1, 16, 2, 12)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention_mh(q, q, q)
    with pytest.raises(ValueError, match="Lq == Lk"):
        flash_attention_mh(torch.zeros(1, 16, 2, 8), torch.zeros(1, 8, 2, 8),
                           torch.zeros(1, 8, 2, 8))
