"""Training of the port: VGG-perceptual loss, Adam train step, epoch driver."""
