"""Plain float32 PyTorch references of the models the program serves."""
