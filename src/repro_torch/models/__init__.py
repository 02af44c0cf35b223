"""Model substrate: the serving path of the zoo (twin of ``repro.models``)."""
