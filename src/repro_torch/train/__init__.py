"""Serve steps: prefill, decode, sampling and generation."""
