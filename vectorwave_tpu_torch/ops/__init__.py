"""Plain PyTorch convolution and thresholding ops of the port."""
