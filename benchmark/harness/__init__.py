"""What every cell of the benchmark shares: files found by name, weights
and inputs from the seed, the device, the trace and the checks."""
