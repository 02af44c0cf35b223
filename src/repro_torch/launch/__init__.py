"""Entry points: LM serving."""
