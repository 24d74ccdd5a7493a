"""RNN cell math, as ``apex_tpu/rnn/cells.py``.

Each cell is a function ``cell(params, x_t, state) -> (new_state,
output)`` over a ``{name: tensor}`` mapping (``w_ih``, ``w_hh``, ``b_ih``,
``b_hh``; ``w_mi`` / ``w_mh`` for the mLSTM), kernels in flax's ``(in,
out)`` layout.  Every product goes through the op layer's
:func:`~apex_tpu_torch.amp.ops.linear`, so an amp O1 policy casts it to
the half dtype as the JAX package's does.

Gate order is torch's: i, f, g, o for the LSTM and the mLSTM; r, z, n
for the GRU, with ``n = tanh(i_n + r * h_n)``.

A cell is the sum of an input part, which needs only ``x_t``, and a
recurrent part: :func:`input_part` and :func:`recurrent_step` split them,
so that a layer computes the input part of every step in one product
(:class:`~apex_tpu_torch.rnn.RNNLayer`); a cell is
``recurrent_step(mode, params, input_part(mode, params, x_t), state)``.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Tuple, Union

import torch

from apex_tpu_torch.amp import ops as amp_ops
from apex_tpu_torch.ops import DeviceLike, resolve_device

GATE_MULTIPLIERS = {"relu": 1, "tanh": 1, "gru": 3, "lstm": 4, "mlstm": 4}


class LSTMState(NamedTuple):
    h: torch.Tensor
    c: torch.Tensor


State = Union[torch.Tensor, LSTMState]
Params = Mapping[str, torch.Tensor]


def _linear(x, w, b=None):
    return amp_ops.linear(x, w, b)


def input_part(mode: str, params: Params, x: torch.Tensor):
    """The products of the input ``x`` (any leading shape): ``x · w_ih +
    b_ih``, and for the mLSTM also ``x · w_mi``."""
    xi = _linear(x, params["w_ih"], params.get("b_ih"))
    if mode == "mlstm":
        return xi, _linear(x, params["w_mi"])
    return xi


def _lstm_gates(gates: torch.Tensor, c_prev: torch.Tensor) -> LSTMState:
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    g = torch.tanh(g)
    c = f * c_prev.to(g.dtype) + i * g
    return LSTMState(h=o * torch.tanh(c), c=c)


def recurrent_step(mode: str, params: Params, xp, state: State
                   ) -> Tuple[State, torch.Tensor]:
    """One step of cell ``mode`` given its input part ``xp``
    (:func:`input_part` of ``x_t``)."""
    if mode in ("relu", "tanh"):
        pre = xp + _linear(state, params["w_hh"], params.get("b_hh"))
        nh = torch.relu(pre) if mode == "relu" else torch.tanh(pre)
        return nh, nh
    if mode == "lstm":
        new = _lstm_gates(
            xp + _linear(state.h, params["w_hh"], params.get("b_hh")),
            state.c)
        return new, new.h
    if mode == "mlstm":
        # the multiplicative intermediate m = (x·W_mi) ⊙ (h·W_mh) takes
        # h's place in the gates (the reference's cells.py:12-84)
        xi, xm = xp
        m = xm * _linear(state.h, params["w_mh"])
        new = _lstm_gates(
            xi + _linear(m, params["w_hh"], params.get("b_hh")), state.c)
        return new, new.h
    if mode == "gru":
        gh = _linear(state, params["w_hh"], params.get("b_hh"))
        i_r, i_z, i_n = xp.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        nh = (1.0 - z) * n + z * state.to(n.dtype)
        return nh, nh
    raise ValueError(f"unknown RNN mode {mode!r}: want one of "
                     f"{sorted(GATE_MULTIPLIERS)}")


def _cell(mode: str):
    def cell(params: Params, x: torch.Tensor, state: State
             ) -> Tuple[State, torch.Tensor]:
        return recurrent_step(mode, params, input_part(mode, params, x),
                              state)
    cell.__name__ = f"{mode}_cell"
    cell.__doc__ = f"One {mode} step: ``(new_state, output)``."
    return cell


relu_cell = _cell("relu")
tanh_cell = _cell("tanh")
gru_cell = _cell("gru")
lstm_cell = _cell("lstm")
mlstm_cell = _cell("mlstm")

CELLS = {"relu": relu_cell, "tanh": tanh_cell, "gru": gru_cell,
         "lstm": lstm_cell, "mlstm": mlstm_cell}


def is_lstm_like(mode: str) -> bool:
    return mode in ("lstm", "mlstm")


def init_state(mode: str, batch: int, hidden: int,
               dtype: torch.dtype = torch.float32,
               device: DeviceLike = None) -> State:
    """Zeros of ``(batch, hidden)``: h, and c too for the LSTM-like modes
    (on the card unless ``device`` says ``"cpu"``)."""
    device = resolve_device(device)
    h = torch.zeros((batch, hidden), dtype=dtype, device=device)
    if is_lstm_like(mode):
        return LSTMState(h=h, c=torch.zeros_like(h))
    return h
