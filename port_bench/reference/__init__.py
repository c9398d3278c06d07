"""The plain reference: PyTorch or NumPy only, nothing of the port."""
