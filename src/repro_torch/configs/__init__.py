"""Architecture configs (llama3.2-1b in this slice)."""
