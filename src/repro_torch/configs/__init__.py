"""Configuration dataclasses (counterpart of repro.configs)."""
