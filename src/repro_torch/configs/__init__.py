"""Architecture configs, the registry of the ten archs and the shape
cells."""
