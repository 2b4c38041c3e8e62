"""The benchmark's own library: the yardstick that later changes to the
program cannot move (registry, statistics, peaks, operation and byte
counts, seeded inputs, the profiler's reduction)."""
