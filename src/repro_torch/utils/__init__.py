"""Configs, device resolution and other shared utilities."""
