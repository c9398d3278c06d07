"""PRGs of the port: the reference's nonstandard ChaCha and AES-128-MMO."""
