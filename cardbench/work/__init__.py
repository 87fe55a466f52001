"""Frozen counts of work: the card's peaks, the model FLOPs of a step and
the least time of each kernel's work.  Copies, so that no change to the
program moves the yardstick."""
