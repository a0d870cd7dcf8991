"""Discrete wavelets of the port: type, generated orthogonal families, registry."""
