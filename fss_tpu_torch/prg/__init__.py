"""PRGs of the port: the reference's nonstandard ChaCha."""
