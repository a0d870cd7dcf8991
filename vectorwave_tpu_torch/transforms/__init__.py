"""Transforms of the port: MODWT (single and multi-level), SWT, packets, the dual tree, 2-D, the CWT and what is built on it (cross-wavelet analysis, significance tests, synchrosqueezing)."""
