"""The benchmark's own code: the registry of cells, the traffic generators,
the weights drawn from a seed, the operation and byte counts, the
published peaks, the spans and the reading of the device trace. None of
it imports the program under test or JAX."""
