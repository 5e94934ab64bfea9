"""Multi-concept fusion: masks, sampler and pipeline."""
