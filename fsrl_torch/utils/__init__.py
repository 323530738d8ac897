"""Parameter bridge, logging and profiling."""
