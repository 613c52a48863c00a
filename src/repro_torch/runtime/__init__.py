"""repro_torch.runtime — the request layer of LM serving.

For now this package holds :class:`LMEngine` (``submit()/step()/drain()``
continuous batching over :class:`repro_torch.launch.serve.ServeEngine`) and
its :class:`LMRequest`.  The reference's supervised ``Runtime``, its fault
injection, telemetry and fleet control wait for ROADMAP Queue A item 3.

Typical use::

    from repro_torch import runtime as rt
    from repro_torch.configs import registry
    from repro_torch.lm.paging import PagedConfig
    from repro_torch.nn import transformer as T
    cfg = registry.get("llama3.2-3b").full()
    eng = rt.LMEngine(cfg, T.init(cfg, 0), slots=32, max_len=545,
                      paged=PagedConfig(block_size=16, prefill_chunk=64))
    rid = eng.submit(prompt_tokens, max_new_tokens=32)
    done = eng.drain()                                # on the card
"""
from repro_torch.runtime.lm import LMEngine, LMRequest

__all__ = ["LMEngine", "LMRequest"]
