"""The GAN train step (generator update, then discriminator update)."""
