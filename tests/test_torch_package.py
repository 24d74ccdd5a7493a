"""The port's package boundary: no module of ``apex_tpu_torch`` (nor
``chip_smoke.py`` or ``chip_split.py``) imports JAX or the JAX package,
and the entry points run on the card unless the caller asks for the
CPU."""

import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

from apex_tpu_torch.convert import params_from_jax
from apex_tpu_torch.models import GPTModel, gpt_tiny
from apex_tpu_torch.models.generate import generate
from apex_tpu_torch.ops import resolve_device
from apex_tpu_torch.serve import ServeConfig, ServeEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "apex_tpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = sorted((ROOT / "apex_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "chip_split.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f) if _forbidden(name)]
    assert bad == []


def test_the_check_tells_the_packages_apart():
    assert _forbidden("apex_tpu.serve") and _forbidden("jax.numpy")
    assert not _forbidden("apex_tpu_torch.serve")


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would use it")
    cfg = gpt_tiny()
    model = GPTModel(cfg, device="cpu").requires_grad_(False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTModel(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, cfg, ServeConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(model, cfg, np.zeros((1, 3), np.int64), 2)
    tree = {k: v.numpy() for k, v in model.state_dict().items()}
    nested = {}
    for name, arr in tree.items():
        node = nested
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(nested, cfg)
    assert resolve_device("cpu") == torch.device("cpu")
    back = params_from_jax(nested, cfg, device="cpu")
    eng = ServeEngine(back, cfg, ServeConfig(), device="cpu")
    assert eng.kc.device.type == "cpu"
    out = generate(back, cfg, np.zeros((1, 3), np.int64), 2, device="cpu")
    assert out.shape == (1, 5)


def test_a_model_elsewhere_is_refused():
    cfg = gpt_tiny()
    model = GPTModel(cfg, device="meta")
    with pytest.raises(ValueError, match="model is on"):
        generate(model, cfg, np.zeros((1, 3), np.int64), 2, device="cpu")


def test_training_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would use it")
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import FusedAdam
    model = GPTModel(gpt_tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FusedAdam(model.parameters())
    opt = FusedAdam(model.parameters(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        amp.initialize(model, opt, opt_level="O2")
    a = amp.initialize(model, opt, opt_level="O2", device="cpu")
    step = amp.make_train_step(a, model, lambda m, x: m(x).float().mean())
    out = step(torch.zeros((1, 4), dtype=torch.long))
    assert set(out) >= {"loss", "overflow", "loss_scale"}
    with pytest.raises(ValueError, match="not the one"):
        amp.make_train_step(a, GPTModel(gpt_tiny(), device="cpu"),
                            lambda m, x: 0)


def test_the_new_modules_are_covered_by_the_import_check():
    names = {str(f.relative_to(ROOT)) for f in
             (ROOT / "apex_tpu_torch").rglob("*.py")}
    assert {"apex_tpu_torch/amp/frontend.py", "apex_tpu_torch/amp/scaler.py",
            "apex_tpu_torch/amp/policy.py",
            "apex_tpu_torch/optimizers/fused_adam.py",
            "apex_tpu_torch/ops/cuda/adam.py",
            "apex_tpu_torch/ops/cuda/multi_tensor.py",
            "apex_tpu_torch/ops/cuda/lamb.py",
            "apex_tpu_torch/ops/multi_tensor.py",
            "apex_tpu_torch/optimizers/fused_lamb.py",
            "apex_tpu_torch/models/bert.py",
            "apex_tpu_torch/optimizers/fp16_optimizer.py",
            "apex_tpu_torch/multi_tensor_apply/multi_tensor_apply.py",
            "apex_tpu_torch/fp16_utils/fp16util.py",
            "apex_tpu_torch/parallel/distributed.py",
            "apex_tpu_torch/parallel/groups.py",
            "apex_tpu_torch/parallel/multiproc.py",
            "apex_tpu_torch/optimizers/larc.py"} <= names


def test_bert_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would use it")
    from apex_tpu_torch.convert import bert_params_from_jax, params_to_numpy
    from apex_tpu_torch.models import BertForPreTraining, bert_tiny
    from apex_tpu_torch.optimizers import FusedLAMB
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BertForPreTraining(bert_tiny())
    model = BertForPreTraining(bert_tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FusedLAMB(model.parameters())
    tree = params_to_numpy(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bert_params_from_jax(tree, bert_tiny())
    back = bert_params_from_jax(tree, bert_tiny(), device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(back.parameters(), model.parameters()))


def test_fp16_optimizer_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would use it")
    from apex_tpu_torch.optimizers import FP16Optimizer
    model = GPTModel(gpt_tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FP16Optimizer(model)
    opt = FP16Optimizer(model, device="cpu")
    assert opt.master.dtype == torch.float32
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    with pytest.raises(ValueError, match="not cpu"):
        FP16Optimizer([torch.zeros(3, device="meta")], device="cpu")


def test_resnet_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would use it")
    from apex_tpu_torch.models import ResNet50, synthetic_batch
    from apex_tpu_torch.parallel import SyncBatchNorm
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ResNet50(width=8, num_classes=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyncBatchNorm(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_batch(torch.Generator(), 2, 8)
    model = ResNet50(width=8, num_classes=4, device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())
    assert all(b.device.type == "cpu" for b in model.buffers())
    x, _ = synthetic_batch(torch.Generator(), 2, 32, device="cpu")
    assert model(x).shape == (2, 4)
