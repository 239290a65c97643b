"""The benchmark's own arithmetic: the H100's peaks, the useful work of a
forward, and K1's roofline bound.  Frozen here so that a change to the
program cannot move the yardstick it is measured by."""
