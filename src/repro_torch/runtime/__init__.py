"""Runtime helpers of the PyTorch port (``repro_torch.runtime.compat``)."""
