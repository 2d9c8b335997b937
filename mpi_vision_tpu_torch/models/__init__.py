"""Networks of the port: the stereo-magnification U-Net."""
