"""Scripts of the PyTorch port, each run as ``python -m
ditsep_tpu_torch.scripts.<name>``."""
