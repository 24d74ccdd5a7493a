"""K15's plain version (``packed_nonfinite_ref``) and the port's
``all_finite_packed`` / ``amp.scaler.all_finite`` against the JAX
package's ``all_finite_packed`` (``apex_tpu/ops/pallas/experimental/
finite_pack.py``, its Pallas kernel in interpret mode on the CPU).

A flag is exact: every placement must give JAX's bool.  The placements
are ``TestAllFinitePacked``'s (``tests/l0/test_scaler.py``: a nan, +inf or
-inf at element (2, 3) of any of four (5, 7) leaves, integer leaves
skipped), plus the first, a middle and the last element of ragged leaves
(sizes that fill no whole chunk nor 16-byte vector), fp16 and bf16 leaves
beside fp32 ones, leaves longer than one chunk, and the empty list.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.pallas.experimental.finite_pack import (
    all_finite_packed as jax_all_finite_packed)
from apex_tpu_torch.amp.scaler import all_finite
from apex_tpu_torch.ops.cuda import (
    all_finite_packed,
    packed_nonfinite,
    packed_nonfinite_ref,
)
from apex_tpu_torch.ops.multi_tensor import ChunkTable, table_for

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.float16: jnp.float16}


@pytest.fixture(autouse=True)
def pallas_mode(monkeypatch):
    monkeypatch.setenv("APEX_TPU_KERNELS", "pallas")


def _leaves(shapes, dtypes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes], \
        list(dtypes)


def _both(arrays, dtypes, ints=True):
    """The JAX tree and the torch list of the same leaves (plus an
    integer leaf in each)."""
    jl = [jnp.asarray(a).astype(JDT[d]) for a, d in zip(arrays, dtypes)]
    tl = [torch.from_numpy(a.copy()).to(d) for a, d in zip(arrays, dtypes)]
    if ints:
        jl.append(jnp.arange(3))
        tl.append(torch.arange(3))
    return jl, tl


def _check(arrays, dtypes, want):
    jl, tl = _both(arrays, dtypes)
    jres = bool(jax_all_finite_packed(jl))
    assert jres == want
    assert bool(all_finite_packed(tl)) == want
    assert bool(all_finite(tl)) == want
    floats = tl[:-1]
    flag = packed_nonfinite(table_for(floats), floats)
    assert flag.dtype == torch.int32 and flag.shape == (1,)
    assert int(flag) == int(not want)


def test_clean_tree_is_finite():
    arrays, dtypes = _leaves([(5, 7)] * 4, [torch.float32] * 4)
    _check(arrays, dtypes, True)


@pytest.mark.parametrize("leaf_i", [0, 1, 2, 3])
@pytest.mark.parametrize("val", [np.nan, np.inf, -np.inf])
def test_detects_nonfinite_in_any_leaf(leaf_i, val):
    arrays, dtypes = _leaves([(5, 7)] * 4, [torch.float32] * 4)
    arrays[leaf_i][2, 3] = val
    _check(arrays, dtypes, False)


RAGGED = [(1,), (37,), (4099,), (2, 3, 5), (70001,)]


@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("val", [np.inf, np.nan])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_ragged_tails_in_every_dtype(where, val, dtype):
    """One inf or nan at the first, a middle or the last element of the
    ragged leaf of 4099 elements (the hazard finite_pack.py names: a tail
    left unchecked), among mixed-dtype leaves."""
    dtypes = [torch.float32, dtype, torch.bfloat16, torch.float16,
              torch.float32]
    arrays, dtypes = _leaves(RAGGED, dtypes, seed=1)
    flat = arrays[2].reshape(-1)
    flat[{"first": 0, "middle": flat.size // 2, "last": -1}[where]] = val
    _check(arrays, dtypes, False)
    arrays[2][...] = 1.0
    _check(arrays, dtypes, True)


def test_a_leaf_of_several_chunks_and_its_last_chunk():
    """A leaf longer than one 65536-element chunk: a value in its last,
    partial chunk is seen (chunk boundaries and the per-chunk table)."""
    arrays, dtypes = _leaves([(3, 70001)], [torch.bfloat16], seed=2)
    _check(arrays, dtypes, True)
    arrays[0][2, 70000] = -np.inf
    _check(arrays, dtypes, False)
    t = ChunkTable([a.size for a in arrays], "cpu")
    assert t.n_chunks == 4


def test_fp16_overflow_of_the_cast_is_not_finite_as_jax():
    """A finite fp32 value beyond fp16's range becomes inf in an fp16
    leaf: both packages see the leaf's own value."""
    arrays, dtypes = _leaves([(8,), (8,)], [torch.float32, torch.float16])
    arrays[1][3] = 1e6
    _check(arrays, dtypes, False)


def test_integer_leaves_are_skipped_and_an_empty_list_is_finite():
    assert bool(jax_all_finite_packed([jnp.arange(4)]))
    assert bool(all_finite_packed([torch.arange(4)]))
    assert bool(all_finite_packed([]))
    assert bool(all_finite([]))


def test_plain_version_checks_the_table():
    xs = [torch.zeros(3), torch.zeros(4)]
    with pytest.raises(ValueError, match="leaf sizes"):
        packed_nonfinite_ref(ChunkTable([3, 5], "cpu"), xs)
    assert int(packed_nonfinite_ref(ChunkTable([], "cpu"), [])) == 0
