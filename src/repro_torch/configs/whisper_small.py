"""whisper-small [audio]: enc-dec, 12L d=768 12H d_ff=3072 vocab=51865.

Conv audio frontend STUBBED per assignment: input_specs provides precomputed
mel-frame embeddings [B, 1500, d] straight into the encoder.  Decoder layers
carry self-attention + cross-attention to the encoder output.  Deviation
noted in DESIGN.md: rotary positions replace Whisper's learned embeddings on
the decoder side (shape-identical).
[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.common import ArchSpec
from repro_torch.nn.transformer import EncoderConfig, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab=51865, norm="layernorm", mlp_kind="gelu",
        block_pattern=("attn_cross_mlp",),
        encoder=EncoderConfig(n_layers=12, d_model=768, n_heads=12, d_ff=3072))


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=512, norm="layernorm", mlp_kind="gelu",
        block_pattern=("attn_cross_mlp",),
        encoder=EncoderConfig(n_layers=2, d_model=64, n_heads=4, d_ff=128,
                              n_frames=8), remat=False)


SPEC = ArchSpec("whisper-small", "audio", full, smoke,
                source="arXiv:2212.04356; unverified")
