"""Synthetic LM data, carried over from :mod:`repro.data`."""
