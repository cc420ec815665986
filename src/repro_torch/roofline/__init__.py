"""Roofline arithmetic of the PyTorch port (``analysis``)."""
