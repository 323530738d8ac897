"""Safe-RL algorithms."""
