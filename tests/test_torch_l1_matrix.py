"""The L1 conformance matrix for the port: a counterpart of
``tests/l1/harness.py``'s ``run_workload`` (its MLP ``(64, 64)`` over 32
features, or its ``ConvBNNet``: Conv 8 x 3, ``SyncBatchNorm``, Dense),
driven through the port's amp with ``FusedAdam(1e-2)`` or ``SGD(0.05,
momentum=0.9)`` (optax's ``sgd`` with momentum: ``dampening=0``), every
loss scale of the matrix (None, 1.0, 128.0, "dynamic"),
``keep_batchnorm_fp32`` and ``inject_inf_at``, on the same numpy data
from ``seed`` and the same initial weights, and held against
``tests.l1.harness.run_workload(kernels="jnp")`` over the configurations
of ``tests/l1/test_conformance.py`` (each once):

- O0: losses within 1e-5 (fp32: the two frameworks' sums differ in their
  last bits);
- O1-O3: losses within 2e-2 (bf16 products round differently in XLA and
  PyTorch), finite, and falling where JAX's fall;
- the scale and overflow sequences equal, the injected inf included.
"""

from typing import Dict, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from apex_tpu.models.mlp import MLP as JaxMLP
from apex_tpu_torch import amp
from apex_tpu_torch.convert import mlp_params_from_jax
from apex_tpu_torch.layers import Conv, Dense
from apex_tpu_torch.models.mlp import cross_entropy_loss
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.parallel import SyncBatchNorm
from tests.l1.harness import ConvBNNet as JaxConvBNNet
from tests.l1.harness import run_workload as jax_run_workload


class ConvBNNet(nn.Module):
    """The harness's tiny conv net: Conv 8 x 3 (no bias), BatchNorm, relu,
    Dense to ``num_classes``, on 8 x 8 x 3 NHWC images."""

    def __init__(self, num_classes: int = 10, device="cpu"):
        super().__init__()
        self.conv1 = Conv(3, 8, 3, device=device)
        self.bn1 = SyncBatchNorm(8, device=device)
        self.fc = Dense(8 * 8 * 8, num_classes, device=device)

    def forward(self, x, train: bool = True):
        x = torch.relu(self.bn1(self.conv1(x),
                                use_running_average=not train))
        return self.fc(x.reshape(x.shape[0], -1))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), v


def _initial_model(with_bn: bool, seed: int) -> nn.Module:
    """The port model holding the JAX harness's initial weights."""
    if not with_bn:
        params = JaxMLP(features=(64, 64)).init(
            jax.random.PRNGKey(seed), jnp.zeros((1, 32)))["params"]
        return mlp_params_from_jax(params, (64, 64), in_features=32,
                                   device="cpu", trainable=True)
    variables = JaxConvBNNet().init(jax.random.PRNGKey(seed),
                                    jnp.zeros((2, 8, 8, 3)), train=True)
    model = ConvBNNet()
    state = {n: torch.from_numpy(np.array(v)) for n, v in
             list(_flat(variables["params"]))
             + list(_flat(variables["batch_stats"]))}
    model.load_state_dict(state)
    return model.train()


def run_workload(opt_level: str = "O1",
                 loss_scale: Union[None, float, str] = None,
                 keep_batchnorm_fp32=None, fused_adam: bool = False,
                 with_bn: bool = False, steps: int = 6, batch: int = 32,
                 seed: int = 0, inject_inf_at: Optional[int] = None
                 ) -> Dict:
    """The port's ``run_workload``: the same digest fields (``losses``,
    ``scales``, ``overflows``) and the final masters."""
    model = _initial_model(with_bn, seed)
    opt = (FusedAdam(model.parameters(), lr=1e-2, device="cpu")
           if fused_adam else
           torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9))
    a = amp.initialize(model, opt, opt_level=opt_level,
                       loss_scale=loss_scale,
                       keep_batchnorm_fp32=keep_batchnorm_fp32,
                       device="cpu")
    step = amp.make_train_step(
        a, model, lambda m, xb, yb: cross_entropy_loss(m(xb), yb))
    rng = np.random.RandomState(seed)
    if with_bn:
        data_x = rng.randn(steps, batch, 8, 8, 3).astype(np.float32)
    else:
        data_x = rng.randn(steps, batch, 32).astype(np.float32)
    data_y = rng.randint(0, 10, (steps, batch))
    losses, scales, overflows = [], [], []
    for i in range(steps):
        xb = torch.from_numpy(data_x[i].copy())
        if inject_inf_at is not None and i == inject_inf_at:
            xb[0] = float("inf")
        m = step(xb, torch.from_numpy(data_y[i]))
        losses.append(float(m["loss"]))
        scales.append(float(m["loss_scale"]))
        overflows.append(bool(m["overflow"]))
    return {"losses": losses, "scales": scales, "overflows": overflows,
            "final_params": {n: t.detach().clone()
                             for n, t in a.masters.items()}}


def _cells():
    """Every configuration of ``tests/l1/test_conformance.py``, once."""
    cells = {}

    def add(**kw):
        kw = {k: v for k, v in kw.items() if v is not None}
        name = "-".join(f"{k}={v}" for k, v in sorted(kw.items()))
        cells[name] = kw

    for lvl in ("O0", "O1", "O2", "O3"):                 # fused vs jnp
        for ls in (None, 128.0):
            add(opt_level=lvl, loss_scale=ls, fused_adam=True)
    for ls in (None, 1.0, 128.0, "dynamic"):             # reruns
        add(opt_level="O1", loss_scale=ls)
    for lvl in ("O0", "O2", "O3"):                       # tracks fp32
        add(opt_level=lvl)
    for lvl in ("O2", "O3"):
        for keep in (True, False):
            for ls in (128.0, "dynamic"):                # fused x keep_bn
                add(opt_level=lvl, loss_scale=ls, keep_batchnorm_fp32=keep,
                    fused_adam=True, with_bn=True)
            add(opt_level=lvl, keep_batchnorm_fp32=keep, with_bn=True)
    add(opt_level="O0", with_bn=True)
    add(opt_level="O2", loss_scale="dynamic", inject_inf_at=2)
    add(opt_level="O2", loss_scale=128.0, inject_inf_at=2)
    return cells


CELLS = _cells()


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_port_run_workload_matches_jax(cell):
    kw = CELLS[cell]
    want = jax_run_workload(kernels="jnp", **kw)
    got = run_workload(**kw)
    assert got["overflows"] == want["overflows"]
    assert got["scales"] == want["scales"]
    tol = 1e-5 if kw["opt_level"] == "O0" else 2e-2
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=tol)
    taken = [l for l, o in zip(got["losses"], got["overflows"]) if not o]
    assert np.all(np.isfinite(taken))
    if want["losses"][-1] < want["losses"][0]:
        assert got["losses"][-1] < got["losses"][0]
    if kw.get("inject_inf_at") is not None:
        assert got["overflows"] == [False, False, True, False, False, False]
        if kw["loss_scale"] == "dynamic":
            assert got["scales"][2] == got["scales"][1] / 2
        else:
            assert set(got["scales"]) == {128.0}


def test_o0_final_masters_match_jax():
    want = jax_run_workload(kernels="jnp", opt_level="O0", fused_adam=True)
    got = run_workload(opt_level="O0", fused_adam=True)
    flat = dict(_flat(want["final_params"]))
    assert set(flat) == set(got["final_params"])
    for n, t in got["final_params"].items():
        np.testing.assert_allclose(t.numpy(), np.asarray(flat[n]), rtol=0,
                                   atol=1e-5)
