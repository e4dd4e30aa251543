"""Architecture configs (llama3.2-1b, falcon-mamba-7b, zamba2-2.7b so far)."""
