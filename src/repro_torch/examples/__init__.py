"""Examples of the PyTorch port, each run with
``python -m repro_torch.examples.<name>``: ``quickstart``,
``online_ridge``, ``kalman_smoother`` and ``serve_lm``. They run on the
card unless given ``--device cpu``."""
