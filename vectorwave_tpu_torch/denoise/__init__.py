"""Wavelet denoising of the port."""
