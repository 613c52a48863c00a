"""Hardware cost model of the CogSys cell array (a copy of the reference's)."""
