"""Example command lines of the port."""
