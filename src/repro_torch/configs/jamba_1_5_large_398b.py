"""jamba-1.5-large-398b [hybrid]: 72L d=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2, Mamba:attention 1:7 interleave.

Period of 8 layers: 7 Mamba + 1 attention (1:7), MoE on every other layer
(4 of 8), mirroring Jamba's block structure.  Mamba layers give O(1) decode
state -> runs the long_500k cell (attention layers' KV at 500k stay under
the sequence-sharded budget).  [arXiv:2403.19887; hf]
"""
from repro_torch.configs.common import ArchSpec
from repro_torch.nn.mamba import MambaConfig
from repro_torch.nn.moe import MoEConfig
from repro_torch.nn.transformer import ModelConfig

_PATTERN = ("mamba_mlp", "mamba_moe", "mamba_mlp", "attn_moe",
            "mamba_mlp", "mamba_moe", "mamba_mlp", "mamba_moe")


def full() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", n_layers=72, d_model=8192, n_heads=64,
        n_kv_heads=8, d_ff=24576, vocab=65536, head_dim=128,
        block_pattern=_PATTERN,
        moe=MoEConfig(d_model=8192, d_ff=24576, num_experts=16, top_k=2),
        mamba=MambaConfig(d_model=8192))


def smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512, head_dim=16, block_pattern=_PATTERN,
        moe=MoEConfig(d_model=64, d_ff=128, num_experts=4, top_k=2),
        mamba=MambaConfig(d_model=64, chunk=16), remat=False)


SPEC = ArchSpec("jamba-1.5-large-398b", "hybrid", full, smoke,
                sub_quadratic=True, optimizer="adafactor",
                opt_state_dtype="bf16", grad_accum=16, source="arXiv:2403.19887; hf")
