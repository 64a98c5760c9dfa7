"""Synthetic corpora, drawn with numpy exactly as the JAX package draws them."""
