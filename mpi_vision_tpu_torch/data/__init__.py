"""Training data of the port: the RealEstate10K pipeline."""
