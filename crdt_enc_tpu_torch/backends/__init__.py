"""The port's plugin backends: in-memory and filesystem storage, the
XChaCha20-Poly1305 cryptor and the plaintext key cryptor."""
