"""Training (PyTorch port): losses and the data-parallel VCI train step."""
