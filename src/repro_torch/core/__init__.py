"""Federated round engine (counterpart of repro.core)."""
