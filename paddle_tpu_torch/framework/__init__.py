"""Framework plumbing of the PyTorch port (flag registry)."""
