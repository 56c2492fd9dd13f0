"""The stacked-client execution backend (``FedConfig(backend="spmd")``)
as a thin adapter over the round pipeline.

Counterpart of ``src/repro/core/rounds_spmd.py``: core/round_program's
``SpmdExecutor`` runs every framework's ready set as stacked programs
per rank bucket (core/fed_spmd.py), under sync and async aggregation,
with privacy, ranks and faults as middleware; ledger bytes equal the
sequential backend's by construction.  ``mesh`` (the reference's
client-axis placement over a device mesh) is not ported, since the
reference's mesh-sharded path is not trusted yet: a mesh other than
None raises, as core/rounds refuses what is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch import tree as tree_lib
from repro_torch.core.round_program import run_program
from repro_torch.kernels import ops as kernel_ops


def run_spmd(model, base, cfg, fed, targets, public: Dict,
             clients_data: List[Dict], test: Dict, task: str,
             batch_size: int, eval_batch: int, verbose: bool, mesh=None):
    """``run_program`` under the ``spmd`` backend and the config's kernel
    policy, on the device of ``base``."""
    if mesh is not None:
        raise NotImplementedError(
            "run_spmd(mesh=...): the client-axis placement over a device "
            "mesh is not ported")
    with kernel_ops.policy_scope(cfg.kernel_policy):
        return run_program(model, base, cfg,
                           dataclasses.replace(fed, backend="spmd"), targets,
                           public, clients_data, test, task, batch_size,
                           eval_batch, verbose,
                           tree_lib.leaves(base)[0].device)
