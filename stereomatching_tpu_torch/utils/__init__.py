"""Device and kernel-build helpers of the PyTorch port."""
