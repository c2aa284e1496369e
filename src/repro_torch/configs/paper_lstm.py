"""The paper's own DL accelerator: LSTM with hidden size 20 ([13], §5.2);
a copy of ``repro.configs.paper_lstm`` for the port.

Used by the faithful-reproduction layer (``examples/quickstart.py`` and
``kernels/lstm``).  Not part of the LM-architecture registry
(``configs.base.get_config``), as in the reference.  The reference's
``padded_hidden`` (the TPU's 128-lane width) is left out: the CUDA kernel
does not pad.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class LstmConfig:
    name: str = "paper-lstm-h20"
    input_dim: int = 6           # e.g. 6-axis IMU time-series window
    hidden_size: int = 20        # paper [13]: LSTM accelerator hidden=20
    seq_len: int = 64
    num_classes: int = 5


def full() -> LstmConfig:
    return LstmConfig()


def reduced() -> LstmConfig:
    return LstmConfig(name="paper-lstm-h20-reduced", seq_len=16)
