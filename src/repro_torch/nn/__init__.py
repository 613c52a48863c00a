"""Transformer building blocks and the decoder stack of LM serving."""
