"""VSA algebra, the resonator factorizer and the adSCH scheduler."""
