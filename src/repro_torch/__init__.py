"""PyTorch/CUDA port of the federated fine-tuning framework in
``src/repro/``.  Same module layout and names as the JAX package, which
stays the reference each module is tested against; this package imports
torch and numpy only, never jax and nothing of ``repro``."""
