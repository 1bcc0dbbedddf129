"""UNet, VAE, CLIP towers and Resampler."""
