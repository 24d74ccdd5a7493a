"""The port's package boundary: no module of ``apex_tpu_torch`` (nor
``chip_smoke.py``) imports JAX or the JAX package, and the entry points
run on the card unless the caller asks for the CPU."""

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
    files.append(ROOT / "chip_smoke.py")
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
    model = GPTModel(cfg).requires_grad_(False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
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
