"""Chip tools that set the benchmark's numbers: the capacity pass, the
serving knee sweep, and the readings behind each correctness limit."""
