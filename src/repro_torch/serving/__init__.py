"""Continuous batching and paged-KV serving."""
