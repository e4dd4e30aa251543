"""Mamba-2 SSD: plain version (:mod:`.ref`) and CUDA kernel wrapper (:mod:`.kernel`)."""
