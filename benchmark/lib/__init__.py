"""The benchmark's yardstick: traffic, weights, FLOP and byte counts, peaks,
and the reading of a profiler trace."""
