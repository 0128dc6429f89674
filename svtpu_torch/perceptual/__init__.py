"""The perceptual (SD-latent) slice of the port: the AutoencoderKL
weights, the embedding encoder and the interpolation demo."""
