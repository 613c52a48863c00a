"""qwen2.5-32b [dense]: 64L d=5120 40H (GQA kv=8) d_ff=27648 vocab=152064,
QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]
"""
from repro_torch.configs.common import ArchSpec
from repro_torch.nn.transformer import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b", n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=27648, vocab=152064, head_dim=128, qkv_bias=True, rope_theta=1e6)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512, head_dim=16, qkv_bias=True, remat=False)


SPEC = ArchSpec("qwen2.5-32b", "dense", full, smoke, grad_accum=2,
                source="hf:Qwen/Qwen2.5-0.5B; hf")
