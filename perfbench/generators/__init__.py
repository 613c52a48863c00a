"""Traffic generators: how a mix offers its requests to the system.  One
module a generator, found by the ``generator`` name in the mix's file; each
has ``run(system, traffic, seconds, probe, patience_s) -> Window``."""
