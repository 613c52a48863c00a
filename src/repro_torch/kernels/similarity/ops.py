"""Public entry point of the int8 codebook similarity.

A tensor on the CPU goes to the plain version (:mod:`.ref`); a CUDA tensor
goes to the hand-written kernel (:mod:`.kernel`), which launches or raises.
There is no third path and no fallback.  Under autograd with an operand
that requires grad it raises (:func:`repro_torch.kernels.refuse_grad`).

``launches`` counts the kernel's launches (a plain integer, bumped by
:mod:`.kernel` once per launch), so a run can show that its int8 scores
went through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantization import QTensor
from repro_torch.kernels import refuse_grad
from repro_torch.kernels.similarity import kernel as _k
from repro_torch.kernels.similarity import ref as _ref

launches = 0  # kernel launches in this process


def codebook_scores(q: torch.Tensor, codebook: QTensor) -> torch.Tensor:
    """Scores [..., M] of queries [..., D] against an int8 codebook [M, D]."""
    refuse_grad("codebook_scores", q, codebook.values, codebook.scale)
    lead = q.shape[:-1]
    q2 = q.reshape(-1, q.shape[-1])
    if q2.device.type == "cpu":
        out = _ref.similarity_int8_ref(q2, codebook.values, codebook.scale)
    else:
        out = _k.similarity_int8(q2.contiguous(), codebook.values,
                                 codebook.scale)
    return out.reshape(*lead, -1)


similarity_int8_ref = _ref.similarity_int8_ref
