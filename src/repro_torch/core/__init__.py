"""Configuration spaces carried over from :mod:`repro.core`."""
