"""FSS schemes of the port: plain PyTorch versions."""
