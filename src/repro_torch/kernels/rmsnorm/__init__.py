"""RMSNorm: plain version (:mod:`.ref`) and CUDA kernel wrapper (:mod:`.kernel`)."""
