"""Small-domain PRP of the port: the AES-128 Feistel network."""
