"""Dense GQA transformer: layers, attention, the stacked forward, the model factory."""
