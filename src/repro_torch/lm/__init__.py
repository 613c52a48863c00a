"""LM serving: the paged KV pool, paged decode and prefill, sampling."""
