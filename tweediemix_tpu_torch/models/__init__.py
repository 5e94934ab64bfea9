"""UNet, VAE and embeddings, and the weight converter from the JAX package."""
