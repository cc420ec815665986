"""Roofline of the PyTorch port: the per-device operation counter
(``opcount``, the counterpart of ``repro.roofline.hloparse``) and the
roofline terms (``analysis``)."""
