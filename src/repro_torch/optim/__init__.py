"""Optimizers (PyTorch port): replicated AdamW and the LR schedules."""
