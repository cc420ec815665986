"""Launch drivers of the PyTorch port: ``serve`` (batched decode)."""
