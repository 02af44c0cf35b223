"""WC-oracle trip step: start-row writes, lexicographic pop, slot clear."""
