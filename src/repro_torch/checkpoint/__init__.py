"""Checkpoints of port trees and of whole federated runs.  Counterpart of
``src/repro/checkpoint/``."""
