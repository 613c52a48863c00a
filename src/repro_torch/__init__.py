"""repro_torch — the PyTorch and CUDA port of the CogSys reproduction.

Its layout mirrors the JAX package ``repro`` module for module, and every
module is checked against its counterpart there on the same inputs.  Every
entry point takes ``device=`` and runs on the card (``"cuda"``) unless the
caller asks for the CPU; see :mod:`repro_torch.device`.
"""
