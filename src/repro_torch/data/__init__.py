"""Data (PyTorch port): the deterministic synthetic text batches."""
