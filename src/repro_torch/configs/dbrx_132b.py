"""dbrx-132b [moe]: 40L d=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16 experts top-4 (fine-grained). [hf:databricks/dbrx-base; unverified]
"""
from repro_torch.configs.common import ArchSpec
from repro_torch.nn.moe import MoEConfig
from repro_torch.nn.transformer import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=10752, vocab=100352, head_dim=128, block_pattern=("attn_moe",),
        rope_theta=5e5,
        moe=MoEConfig(d_model=6144, d_ff=10752, num_experts=16, top_k=4))


def smoke() -> ModelConfig:
    return ModelConfig(
        name="dbrx-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512, head_dim=16, block_pattern=("attn_moe",),
        moe=MoEConfig(d_model=64, d_ff=128, num_experts=4, top_k=2), remat=False)


SPEC = ArchSpec("dbrx-132b", "moe", full, smoke, opt_state_dtype="bf16", grad_accum=8,
                source="hf:databricks/dbrx-base; unverified")
