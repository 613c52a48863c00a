"""granite-moe-3b-a800m [moe]: 32L d=1536 24H (GQA kv=8) d_ff=512/expert
vocab=49155, MoE 40 experts top-8 (fine-grained experts).

Assignment line says 40e top-8 (matches granite-3.0-3b-a800m); the hf comment
cites the 1b-a400m sibling — we follow the config field (DESIGN.md Sec. 4).
[hf:ibm-granite; hf]
"""
from repro_torch.configs.common import ArchSpec
from repro_torch.nn.moe import MoEConfig
from repro_torch.nn.transformer import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", n_layers=32, d_model=1536, n_heads=24,
        n_kv_heads=8, d_ff=512, vocab=49155, head_dim=64,
        block_pattern=("attn_moe",),
        moe=MoEConfig(d_model=1536, d_ff=512, num_experts=40, top_k=8))


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab=512, head_dim=16, block_pattern=("attn_moe",),
        moe=MoEConfig(d_model=64, d_ff=64, num_experts=4, top_k=2), remat=False)


SPEC = ArchSpec("granite-moe-3b-a800m", "moe", full, smoke,
                source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf")
