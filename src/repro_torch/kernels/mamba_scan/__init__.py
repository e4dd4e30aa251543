"""Mamba-1 selective scan: plain version (:mod:`.ref`) and CUDA kernel wrapper (:mod:`.kernel`)."""
