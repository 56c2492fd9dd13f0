"""Data generation, partitioning and batching (counterpart of repro.data)."""
