"""Policy and value networks."""
