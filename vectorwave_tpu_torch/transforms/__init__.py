"""MODWT transforms of the port: single level and multi-level."""
