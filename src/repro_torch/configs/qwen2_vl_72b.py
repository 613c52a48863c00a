"""qwen2-vl-72b [vlm]: 80L d=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.

M-RoPE (temporal/height/width frequency sections) + dynamic-resolution vision
frontend STUBBED per assignment: input_specs provides precomputed patch
embeddings that overwrite the first `vision_patches` token positions.
[arXiv:2409.12191; hf]
"""
from repro_torch.configs.common import ArchSpec
from repro_torch.nn.transformer import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b", n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=29568, vocab=152064, head_dim=128, qkv_bias=True,
        rope_theta=1e6, mrope_sections=(16, 24, 24), vision_patches=256)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512, head_dim=16, qkv_bias=True,
        rope_theta=1e6, mrope_sections=(2, 3, 3), vision_patches=4, remat=False)


SPEC = ArchSpec("qwen2-vl-72b", "vlm", full, smoke, sub_quadratic=False,
                opt_state_dtype="bf16", grad_accum=4, source="arXiv:2409.12191; hf")
