"""Neurosymbolic models served by the engine."""
