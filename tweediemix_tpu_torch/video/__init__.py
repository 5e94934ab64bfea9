"""Image-to-video generation: the I2VGen-XL pipeline."""
