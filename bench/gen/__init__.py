"""The benchmark's own generators of inputs, deterministic in the seed."""
