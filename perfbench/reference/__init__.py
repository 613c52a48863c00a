"""Plain PyTorch reference of the benchmarked computations.

A frozen copy of the arithmetic the port serves, written with plain tensor
operations: the counter-based Philox normals (:mod:`.philox`), block-code
VSA algebra (:mod:`.vsa`), per-row quantisation (:mod:`.quant`), the
stochastic resonator sweep (:mod:`.factorizer`) and NVSA's abduction tail
(:mod:`.nvsa`).  It imports nothing of the port and takes nothing the port
has made: codebooks, queries and keys come from the benchmark's inputs.
"""
