"""starcoder2-3b [dense]: 30L d=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.
GQA with only 2 KV heads, RoPE, GeLU MLP + layernorm (starcoder2 family).
[arXiv:2402.19173; hf]
"""
from repro_torch.configs.common import ArchSpec
from repro_torch.nn.transformer import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b", n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
        d_ff=12288, vocab=49152, head_dim=128, norm="layernorm",
        mlp_kind="gelu", qkv_bias=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512, head_dim=16, norm="layernorm", mlp_kind="gelu",
        qkv_bias=True, remat=False)


SPEC = ArchSpec("starcoder2-3b", "dense", full, smoke,
                source="arXiv:2402.19173; hf")
