"""Sharding rules of the PyTorch port (``repro_torch.sharding.rules``)."""
