"""Arch registry: ``--arch <id>`` resolution for ``launch/`` and the tests.

The port holds the architectures whose every block it can run; the others
wait for ROADMAP Queue A item 2 (``nn/moe.py``, ``nn/mamba.py``,
``nn/xlstm.py``, M-RoPE, the encoder) and are not listed here.
"""
from repro_torch.configs import llama3_2_3b

ARCHS = {m.SPEC.arch_id: m.SPEC for m in (llama3_2_3b,)}


def get(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; the port has "
                       f"{sorted(ARCHS)} (the reference's other archs wait "
                       "for ROADMAP Queue A item 2)")
    return ARCHS[arch_id]
