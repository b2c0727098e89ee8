"""Frozen operation and byte counts of the port's kernels and model, and
the chip's published peaks: the benchmark's yardstick.  A change to a
kernel does not change these."""
