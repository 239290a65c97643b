"""The general part of the benchmark: what every cell runs alike."""
