"""Single-concept personalisation training (Custom Diffusion and LoRA),
the counterpart of ``tweediemix_tpu/training/``."""
