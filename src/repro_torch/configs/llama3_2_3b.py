"""llama3.2-3b [dense]: 28L d=3072 24H (GQA kv=8) d_ff=8192 vocab=128256.

Width and depth are those of hf:meta-llama/Llama-3.2-3B.  Two departures
follow the reference config this port is held against: the LM head is
untied (the published model ties it to the embedding, 3.21 B parameters;
this one has 3.61 B) and RoPE runs without the published ``llama3``
frequency scaling (plain theta = 5e5).
"""
from repro_torch.configs.common import ArchSpec
from repro_torch.nn.transformer import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b", n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab=128256, head_dim=128, rope_theta=5e5)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512, head_dim=16, rope_theta=5e5, remat=False)


SPEC = ArchSpec("llama3.2-3b", "dense", full, smoke,
                source="hf:meta-llama/Llama-3.2-3B (untied head, no llama3 "
                       "RoPE scaling, as the reference config)")
