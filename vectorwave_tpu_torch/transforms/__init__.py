"""Transforms of the port: MODWT (single and multi-level), SWT, packets, the dual tree, 2-D, and the CWT."""
