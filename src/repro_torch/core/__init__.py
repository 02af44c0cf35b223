"""Placement core: graph IR, fleets, features, policies, rollout, oracle."""
