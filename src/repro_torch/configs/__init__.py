"""Architecture configs (copies of ``src/repro/configs``) and the registry."""
