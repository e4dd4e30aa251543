"""Prefill and decode attention: plain versions and CUDA kernel wrappers."""
