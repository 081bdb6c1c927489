"""Step builders of the port (serving only; training is a later slice)."""
