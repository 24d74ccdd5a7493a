"""apex_tpu_torch.rnn: the RNN stack (``apex_tpu/rnn``, the reference's
``apex/RNN``): the factories ``LSTM``, ``GRU``, ``ReLU``, ``Tanh`` and
``mLSTM`` and the module and cell building blocks."""

from apex_tpu_torch.rnn.cells import (
    CELLS,
    GATE_MULTIPLIERS,
    LSTMState,
    init_state,
    is_lstm_like,
)
from apex_tpu_torch.rnn.models import (GRU, LSTM, RNN, ReLU, RNNLayer, Tanh,
                                       mLSTM)

__all__ = [
    "RNN", "RNNLayer", "LSTM", "GRU", "ReLU", "Tanh", "mLSTM",
    "CELLS", "GATE_MULTIPLIERS", "LSTMState", "init_state", "is_lstm_like",
]
