"""Minimizer reference index (copy of minialign_tpu/index)."""
