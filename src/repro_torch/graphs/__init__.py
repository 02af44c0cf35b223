"""Experiment graphs (paper Appendix D) and their sharded builder."""
