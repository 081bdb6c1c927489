"""Synthetic, deterministic training data of the port."""
