"""Launch drivers of the PyTorch port: ``serve`` (batched decode),
``train`` (the training driver), ``steps`` (the step bodies and the cells'
input specs) and ``mesh``."""
