"""Examples of the PyTorch port, each run with
``python -m repro_torch.examples.<name>``: ``quickstart``,
``online_ridge``, ``kalman_smoother``, ``serve_lm`` and ``train_lm``.
They run on the card unless given ``--device cpu``."""
