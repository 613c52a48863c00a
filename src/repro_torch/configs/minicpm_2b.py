"""minicpm-2b [dense]: 40L d=2304 36H (MHA kv=36) d_ff=5760 vocab=122753.
Llama-like architecture trained with the WSD schedule (train/optimizer.py
implements warmup-stable-decay; launch/train.py selects it for this arch).
[arXiv:2404.06395; hf]
"""
from repro_torch.configs.common import ArchSpec
from repro_torch.nn.transformer import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b", n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
        d_ff=5760, vocab=122753, head_dim=64, tie_embeddings=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="minicpm-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=512, head_dim=16, tie_embeddings=True, remat=False)


SPEC = ArchSpec("minicpm-2b", "dense", full, smoke, schedule="wsd",
                source="arXiv:2404.06395; hf")
