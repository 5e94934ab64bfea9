"""Concept-delta checkpoints: loading, saving and stacking into the UNet."""
