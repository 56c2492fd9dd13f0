"""Functional GPT-2 substrate (counterpart of repro.models)."""
