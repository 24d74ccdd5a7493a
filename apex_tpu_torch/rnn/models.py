"""Stacked and bidirectional RNNs, as ``apex_tpu/rnn/models.py``: the
reference's ``stackedRNN`` / ``bidirectionalRNN`` loop over time and the
factories of ``apex/RNN/models.py`` (``LSTM``, ``GRU``, ``ReLU``,
``Tanh``, ``mLSTM``).

Layout is (time, batch, features).  Parameters keep the JAX package's
names and flax's ``(in, out)`` layout (``layer_{i}_fwd.w_ih``, ``w_hh``,
``b_ih``, ``b_hh``, ``w_mi``, ``w_mh``, ``w_ho``, and ``layer_{i}_bwd.*``
when bidirectional), so :func:`~apex_tpu_torch.convert.
rnn_params_from_jax` copies a JAX tree across by name.  Kernels are drawn
as flax's ``uniform(scale=1/sqrt(hidden_size))``, from ``[0, scale)``;
biases start at zero.

The recurrence is a Python loop over the steps (backwards for the
``_bwd`` direction); the input products of all steps are one product
before it.  ``output_size`` projects h by ``w_ho`` before it re-enters
the recurrence, and the projected h is the output.  ``seq_lengths``
(one length a sequence) carries the state of a padded step through
unchanged and emits zeros there, so the reverse direction starts at each
sequence's own last step.  Under an amp O1 policy the inputs and a given
initial state go to the half dtype up front.

What the JAX package cannot run is refused with ``ValueError``: a GRU or
mLSTM whose ``output_size`` differs from ``hidden_size`` (JAX fails at
init: h takes the projected width where the cell needs the hidden one)
and any ``output_size`` under an O1 policy (JAX's scan fails: the
projection is outside the op layer and widens the carry to fp32).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from apex_tpu_torch.amp import ops as amp_ops
from apex_tpu_torch.ops import DeviceLike, resolve_device
from apex_tpu_torch.rnn import cells as C


def _uniform(shape, scale: float, dtype, device, generator):
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.rand(shape, generator=generator, dtype=torch.float32) * scale
    return w.to(device=device, dtype=dtype)


def _map_state(fn, *states):
    if isinstance(states[0], C.LSTMState):
        return C.LSTMState(*(fn(*parts) for parts in zip(*states)))
    return fn(*states)


class RNNLayer(nn.Module):
    """One direction of one layer: ``forward(xs (T, B, input_size),
    init_state=None, seq_lengths=None) -> (ys, final_state)``."""

    def __init__(self, mode: str, input_size: int, hidden_size: int,
                 output_size: Optional[int] = None, bias: bool = True,
                 reverse: bool = False, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mode not in C.GATE_MULTIPLIERS:
            raise ValueError(f"unknown RNN mode {mode!r}: want one of "
                             f"{sorted(C.GATE_MULTIPLIERS)}")
        if mode in ("gru", "mlstm") and output_size is not None \
                and output_size != hidden_size:
            raise ValueError(
                f"mode {mode!r} with output_size {output_size} != "
                f"hidden_size {hidden_size}: the JAX package cannot run "
                "it (the cell multiplies the projected h at the hidden "
                "width)")
        device = resolve_device(device, allow_meta=True)
        self.mode, self.hidden_size = mode, hidden_size
        self.output_size, self.reverse = output_size, reverse
        gm = C.GATE_MULTIPLIERS[mode] * hidden_size
        hidden_in = output_size or hidden_size
        scale = 1.0 / hidden_size ** 0.5

        def kernel(*shape):
            return nn.Parameter(_uniform(shape, scale, dtype, device,
                                         generator))

        self.w_ih = kernel(input_size, gm)
        self.w_hh = kernel(hidden_in, gm)
        if bias:
            self.b_ih = nn.Parameter(torch.zeros(gm, dtype=dtype,
                                                 device=device))
            self.b_hh = nn.Parameter(torch.zeros(gm, dtype=dtype,
                                                 device=device))
        if mode == "mlstm":
            self.w_mi = kernel(input_size, hidden_size)
            self.w_mh = kernel(hidden_in, hidden_size)
        if output_size is not None:
            self.w_ho = kernel(hidden_size, output_size)

    _NAMES = ("w_ih", "w_hh", "b_ih", "b_hh", "w_mi", "w_mh", "w_ho")

    def cell_params(self) -> dict:
        """``{name: tensor}`` of the cell's weights, as this forward sees
        them (a reparameterization's recomputed weights included)."""
        return {n: getattr(self, n) for n in self._NAMES
                if hasattr(self, n)}

    def forward(self, xs: torch.Tensor, init_state=None,
                seq_lengths: Optional[torch.Tensor] = None):
        policy = amp_ops.active_policy()
        if policy is not None:
            if self.output_size is not None:
                raise ValueError(
                    "output_size under an amp O1 cast policy: the JAX "
                    "package cannot run it (the projection widens the "
                    "recurrent state to fp32)")
            xs = xs.to(policy.half_dtype)
            if init_state is not None:
                init_state = _map_state(lambda t: t.to(policy.half_dtype),
                                        init_state)
        p = self.cell_params()
        steps, batch = xs.shape[0], xs.shape[1]
        out_size = self.output_size or self.hidden_size
        if init_state is None:
            h = torch.zeros((batch, out_size), dtype=xs.dtype,
                            device=xs.device)
            init_state = C.LSTMState(h=h, c=torch.zeros(
                (batch, self.hidden_size), dtype=xs.dtype,
                device=xs.device)) if C.is_lstm_like(self.mode) else h
        # one view a step (unbind: its backward stacks the steps'
        # cotangents once, where indexing would add a zero-filled copy of
        # the whole product a step)
        xp = C.input_part(self.mode, p, xs)
        if isinstance(xp, tuple):
            xp = list(zip(*(a.unbind(0) for a in xp)))
        else:
            xp = xp.unbind(0)
        valid = None
        if seq_lengths is not None:
            t_idx = torch.arange(steps, device=xs.device)
            valid = (t_idx[:, None] < seq_lengths.to(xs.device)[None, :])
        state, ys = init_state, [None] * steps
        order = range(steps - 1, -1, -1) if self.reverse else range(steps)
        for t in order:
            new, out = C.recurrent_step(self.mode, p, xp[t], state)
            if self.output_size is not None:
                out = out @ p["w_ho"]
                new = C.LSTMState(h=out, c=new.c) \
                    if C.is_lstm_like(self.mode) else out
            if valid is not None:
                m = valid[t][:, None]
                new = _map_state(lambda n, o: torch.where(m, n, o), new,
                                 state)
                out = torch.where(m, out, torch.zeros_like(out))
            state, ys[t] = new, out
        return torch.stack(ys), state


class RNN(nn.Module):
    """Stacked, optionally bidirectional RNN of ``mode`` (``"relu"``,
    ``"tanh"``, ``"gru"``, ``"lstm"``, ``"mlstm"``).  ``forward(xs (T, B,
    input_size), init_states=None, seq_lengths=None) -> (outputs,
    finals)``: outputs ``(T, B, out · dirs)`` (the bidirectional output
    joins the two directions on the last axis), finals one state a layer
    (a ``(fwd, bwd)`` tuple when bidirectional).  Built on the card unless
    ``device`` says ``"cpu"`` (or ``"meta"``); the kernels are drawn
    from ``generator`` (torch's default generator when None)."""

    def __init__(self, mode: str, input_size: int, hidden_size: int,
                 num_layers: int = 1, bias: bool = True,
                 bidirectional: bool = False,
                 output_size: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device, allow_meta=True)
        self.mode, self.num_layers = mode, num_layers
        self.bidirectional = bidirectional
        dirs = ("fwd", "bwd") if bidirectional else ("fwd",)
        width = input_size
        for i in range(num_layers):
            for d in dirs:
                setattr(self, f"layer_{i}_{d}", RNNLayer(
                    mode, width, hidden_size, output_size, bias,
                    reverse=d == "bwd", dtype=dtype, device=device,
                    generator=generator))
            width = (output_size or hidden_size) * len(dirs)

    def forward(self, xs: torch.Tensor,
                init_states: Optional[Sequence] = None,
                seq_lengths: Optional[torch.Tensor] = None):
        finals: List = []
        h = xs
        for i in range(self.num_layers):
            init = None if init_states is None else init_states[i]
            fwd = getattr(self, f"layer_{i}_fwd")
            if self.bidirectional:
                init_f, init_b = (None, None) if init is None else init
                ys_f, fin_f = fwd(h, init_f, seq_lengths)
                ys_b, fin_b = getattr(self, f"layer_{i}_bwd")(
                    h, init_b, seq_lengths)
                h = torch.cat([ys_f, ys_b], dim=-1)
                finals.append((fin_f, fin_b))
            else:
                h, fin = fwd(h, init, seq_lengths)
                finals.append(fin)
        return h, finals


# -- the factories (the reference's models.py:7-54) ----------------------------

def LSTM(input_size: int, hidden_size: int, **kw) -> RNN:
    return RNN("lstm", input_size, hidden_size, **kw)


def GRU(input_size: int, hidden_size: int, **kw) -> RNN:
    return RNN("gru", input_size, hidden_size, **kw)


def ReLU(input_size: int, hidden_size: int, **kw) -> RNN:
    return RNN("relu", input_size, hidden_size, **kw)


def Tanh(input_size: int, hidden_size: int, **kw) -> RNN:
    return RNN("tanh", input_size, hidden_size, **kw)


def mLSTM(input_size: int, hidden_size: int, **kw) -> RNN:
    return RNN("mlstm", input_size, hidden_size, **kw)
