"""DTensor layout helpers for the dry run (launch/dryrun.py distributes
a step's arguments on a DeviceMesh).  A plain tensor passes every helper
here untouched, so no CPU or CUDA run changes.

A leaf module (it imports only torch): the kernels' dispatch
(kernels/ops.py), the models, the federated cores and the optimizer
take their layout helpers from here.
"""
from __future__ import annotations

import contextlib
import math

import torch

_REPLICATED = None          # the sites noted while recording, else None


def shard_dim(p):
    """The tensor dim a DTensor placement shards (a ``Shard`` or a strided
    shard), else None."""
    return None if p.is_replicate() or p.is_partial() else p.dim


def is_distributed(x) -> bool:
    """Whether ``x`` is a DTensor (plain tensors short-cut the import)."""
    if type(x) is torch.Tensor or not torch.is_tensor(x):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _placements(x, spec):
    """The placements of spec entries (None, an axis name or a tuple of
    names a dim; launch/sharding's P) on x's mesh: ``Shard(d)`` on a mesh
    axis that dim d names, ``Replicate()`` elsewhere.  Axes the mesh
    lacks, axes of extent 1 and axes whose extents (with the dim's axes
    before them) do not divide the dim are dropped."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    dims = {}
    for d, entry in enumerate(spec):
        m = 1
        for name in entry if isinstance(entry, (tuple, list)) else (entry,):
            if name in names and mesh.size(names.index(name)) > 1 \
                    and x.shape[d] % (m * mesh.size(names.index(name))) == 0:
                m *= mesh.size(names.index(name))
                dims[name] = d
    # a dim already sharded over an axis keeps its layout there (a
    # strided shard: the stacked clients' rows, each rank a block of each)
    now = dict(zip(names, x.placements))
    return tuple((now[a] if shard_dim(now[a]) == dims[a] else Shard(dims[a]))
                 if a in dims else Replicate() for a in names)


def _relabelled(x, placements):
    """x's local shard as a DTensor of ``placements``, no data moved: the
    forward is x, and the gradient is brought to ``placements`` before it
    reaches x."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x.to_local(), x.device_mesh, placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def plain_shards(x):
    """DTensor ``x`` with each strided shard of split factor 1 (which
    DTensor's view rules make of a flattened batch) relabelled the
    ``Shard`` it is, with no data moved: DTensor's redistribute planner
    searches a large space for layouts that mix the two on one dim."""
    from torch.distributed.tensor import Shard

    pl = tuple(Shard(p.dim) if shard_dim(p) is not None and not p.is_shard()
               and getattr(p, "split_factor", None) == 1 else p
               for p in x.placements)
    return x if pl == tuple(x.placements) else _relabelled(x, pl)


def hint(x, *spec):
    """The reference's sharding hint (``with_sharding_constraint``): a
    DTensor redistributed to ``spec`` on its own mesh; anything else as
    it is.  The reference's hint names ("pod", "data") and is dropped on
    a mesh without a "pod" axis (jax refuses the spec); here the missing
    axis is dropped instead, since DTensor's op-by-op propagation does
    not find the layout by itself as GSPMD does."""
    if not is_distributed(x):
        return x
    x = plain_shards(x)
    pl = _placements(x, spec)
    x = relayout(x, pl)
    # the gradient takes the same layout (as GSPMD's constraint holds the
    # cotangent too): DTensor would pass a partial sum on, and the next
    # product would gather its weight rather than reduce it
    return _relabelled(x, pl) if x.requires_grad else x


@contextlib.contextmanager
def recording_replications():
    """Yields the list of sites where ``replicated`` forced a DTensor dim
    whole (each site once, in order), while active."""
    global _REPLICATED
    prev, _REPLICATED = _REPLICATED, []
    try:
        yield _REPLICATED
    finally:
        _REPLICATED = prev


def replicated(x, dims, site: str):
    """A DTensor with tensor ``dims`` whole on every rank (sharding over
    them gathered, partial sums reduced), its other shards kept, for an
    op that has no rule over sharded ``dims``; the site is noted for
    ``recording_replications``.  Anything else as it is."""
    if not is_distributed(x):
        return x
    from torch.distributed.tensor import Replicate

    dims = {d % x.dim() for d in dims}
    pl = tuple(Replicate() if p.is_partial() or (
        shard_dim(p) in dims) else p for p in x.placements)
    if pl == tuple(x.placements):
        return x
    if _REPLICATED is not None and site not in _REPLICATED:
        _REPLICATED.append(site)
    return x.redistribute(x.device_mesh, pl)


def shard_extent(x, dim: int) -> int:
    """The product of the mesh extents a DTensor's ``dim`` is sharded
    over (1 when whole, and for a plain tensor)."""
    if not is_distributed(x):
        return 1
    return math.prod(x.device_mesh.size(i) for i, p in enumerate(
        x.placements) if shard_dim(p) == dim % x.dim())


def relayout(x, placements):
    """DTensor ``x`` in ``placements``; ``x`` itself when it is in them
    already (a redistribute to the same layout would still, in its
    backward, bring a partial-sum gradient back to x's layout)."""
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def rows_like(t, x):
    """A plain tensor ``t`` whose leading dims are x's batch, as a
    DTensor holding this rank's rows where x's dim 0 is sharded (a local
    chunk, no communication), else as it is: a plain tensor beside
    DTensors is taken whole on every rank."""
    if not is_distributed(x) or is_distributed(t) or t.dim() < 2 \
            or t.shape[0] != x.shape[0]:
        return t
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    pl = [p if shard_dim(p) == 0 else Replicate() for p in x.placements]
    local, offset = compute_local_shape_and_global_offset(
        t.shape, x.device_mesh, pl)
    return DTensor.from_local(t.narrow(0, offset[0], local[0]),
                              x.device_mesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())


def split_rows(x, n: int, site: str):
    """x (n·m, ...) -> (n, m, ...): the stacked clients' rows as a client
    axis.  A DTensor's sharded row dim, which DTensor cannot split into
    an axis of fewer than its shards, is made whole first (noted at
    ``site``)."""
    if shard_extent(x, 0) > 1:
        x = replicated(x, (0,), site)
    return x.view(n, -1, *x.shape[1:])


def seq_slice(x, start: int, stop: int):
    """``x[:, start:stop]``.  A DTensor is cut by ``split``, whose
    backward DTensor runs on the shards (a slice's backward it runs on
    the whole tensor); the same values either way."""
    if not is_distributed(x):
        return x[:, start:stop]
    S = x.shape[1]
    start, stop, _ = slice(start, stop).indices(S)
    if (start, stop) == (0, S):
        return x
    return x.split([start, stop - start, S - stop], dim=1)[1]
