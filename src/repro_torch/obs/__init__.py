"""repro_torch.obs — spans and metrics recorded around the serving loop.

Copies of the reference package's ``obs`` recorder, span store, metrics
registry and Chrome-trace export.  :data:`NULL` is the default recorder:
every method is a constant-time no-op, so an engine built without a recorder
does no recording work.
"""
from repro_torch.obs.recorder import DEFAULT_CLOCK, NULL, NullRecorder, Recorder

__all__ = ["DEFAULT_CLOCK", "NULL", "NullRecorder", "Recorder"]
