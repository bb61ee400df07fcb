"""Measurement tools of the port (counterparts of the JAX package's
``tools/``); each runs on the card only."""
