"""Arch registry: ``--arch <id>`` resolution for ``launch/`` and the tests.

All ten of the reference's architectures, with its full and smoke configs.
"""
from repro_torch.configs import (dbrx_132b, granite_moe_3b_a800m,
                                 jamba_1_5_large_398b, llama3_2_3b,
                                 minicpm_2b, qwen2_5_32b, qwen2_vl_72b,
                                 starcoder2_3b, whisper_small, xlstm_125m)

ARCHS = {m.SPEC.arch_id: m.SPEC for m in (
    qwen2_vl_72b, granite_moe_3b_a800m, dbrx_132b, llama3_2_3b, minicpm_2b,
    qwen2_5_32b, starcoder2_3b, xlstm_125m, whisper_small,
    jamba_1_5_large_398b)}


def get(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]
