"""xlstm-125m [ssm]: 12L d=768 4H vocab=50304 — alternating mLSTM / sLSTM
blocks (recurrent, O(1) decode state -> runs the long_500k cell).
[arXiv:2405.04517; unverified]
"""
from repro_torch.configs.common import ArchSpec
from repro_torch.nn.transformer import ModelConfig
from repro_torch.nn.xlstm import XLSTMConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304, block_pattern=("mlstm", "slstm"),
        xlstm=XLSTMConfig(d_model=768, n_heads=4))


def smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
        d_ff=0, vocab=512, block_pattern=("mlstm", "slstm"),
        xlstm=XLSTMConfig(d_model=64, n_heads=2), remat=False)


SPEC = ArchSpec("xlstm-125m", "ssm", full, smoke, sub_quadratic=True,
                source="arXiv:2405.04517; unverified")
