"""Paged decode attention: plain version and CUDA kernel wrapper."""
