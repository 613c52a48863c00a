"""mellum2-12b-a2.5b [moe]: 28L d=2304 32H (GQA kv=4, dh 128) vocab=98304,
every layer a dropless MoE of 64 experts of 896, top-8 (normalised), no
shared expert; attention 3:1 sliding (window 1024, RoPE theta 5e5) to full
(YaRN: factor 16 over 8192 original positions, beta 32 / 1, attention
factor 1.2772588722239782); RMSNorm eps 1e-6, untied head, 131072
positions.  The reference package has no such architecture: the port's
own, served paged through ``LMEngine``.
[hf:JetBrains/Mellum2-12B-A2.5B-Instruct config.json]
"""
from repro_torch.configs.common import ArchSpec
from repro_torch.nn.layers import YaRN
from repro_torch.nn.moe import MoEConfig
from repro_torch.nn.transformer import ModelConfig

ATTN_PATTERN = ("sliding", "sliding", "sliding", "full")
YARN = YaRN(factor=16.0, original_max_position_embeddings=8192,
            beta_fast=32.0, beta_slow=1.0,
            attention_factor=1.2772588722239782)


def full() -> ModelConfig:
    return ModelConfig(
        name="mellum2-12b-a2.5b", n_layers=28, d_model=2304, n_heads=32,
        n_kv_heads=4, d_ff=896, vocab=98304, head_dim=128,
        block_pattern=("attn_moe",), rope_theta=5e5,
        attn_pattern=ATTN_PATTERN, sliding_window=1024, yarn=YARN,
        moe=MoEConfig(d_model=2304, d_ff=896, num_experts=64, top_k=8),
        moe_dropless=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mellum2-smoke", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=32, vocab=512, head_dim=16, block_pattern=("attn_moe",),
        rope_theta=5e5, attn_pattern=ATTN_PATTERN, sliding_window=20,
        yarn=YaRN(factor=16.0, original_max_position_embeddings=64,
                  beta_fast=32.0, beta_slow=1.0,
                  attention_factor=1.2772588722239782),
        moe=MoEConfig(d_model=64, d_ff=32, num_experts=8, top_k=2),
        moe_dropless=True, remat=False)


SPEC = ArchSpec("mellum2-12b-a2.5b", "moe", full, smoke,
                source="hf:JetBrains/Mellum2-12B-A2.5B-Instruct; hf")
