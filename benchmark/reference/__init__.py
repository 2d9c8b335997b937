"""The plain reference that decides ``correct``: float64 PyTorch and NumPy,
independent of the measured program."""
