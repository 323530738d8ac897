"""Parameter bridge and logging."""
