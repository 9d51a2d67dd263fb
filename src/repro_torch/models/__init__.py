"""Model code of the port (dense text family): layers, attention, model."""
