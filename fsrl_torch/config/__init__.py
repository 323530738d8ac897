"""Training configs and the dataclass-driven command line."""
