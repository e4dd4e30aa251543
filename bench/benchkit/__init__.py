"""The benchmark harness of the PyTorch and CUDA port (``repro_torch``):
cells, traffic, the driver of the port's continuous batcher, the traced
sub-window and the check that decides ``correct``."""
