"""Logical-axis sharding on DTensors: flax-style rules without flax.

Port of ``repro.sharding``. Model code annotates activations with
*logical* axis names via ``shard(x, "batch", "seq", None)``. The
launcher installs a mesh and a ``{logical name -> mesh axis (or tuple,
or None)}`` rule table with ``axis_rules(...)``; outside such a context
every helper here returns its input object unchanged, so the one-device
path never touches ``torch.distributed`` and stays bit for bit what it
was.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
axes (:mod:`repro_torch.launch.mesh`). ``spec_for(names)`` gives the
tuple of mesh-axis entries a ``PartitionSpec`` would hold, one per
tensor dimension; ``sharding_for``/``tree_shardings`` turn specs into
DTensor placements, one per mesh axis: ``Shard(d)`` on every mesh axis
that tensor dimension ``d`` is mapped to, ``Replicate()`` elsewhere. A
dimension mapped to a tuple of axes (``("pod", "data")``) is sharded
over them in mesh order, major to minor, as JAX lays it out.

``shard(x, *names)`` is the analogue of ``with_sharding_constraint``:
it redistributes a DTensor to the placements of its names (a
``Partial`` sum becomes a reduce-scatter or an all-reduce there), and
splits a plain tensor, which every rank holds whole (a batch from the
seeded pipeline), into its local shard without communication.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

from repro_torch.pytree import flatten_with_path, unflatten_like

Axis = Union[None, str, Tuple[str, ...]]

_STATE = threading.local()


def _st():
    if not hasattr(_STATE, "mesh"):
        _STATE.mesh = None
        _STATE.rules = {}
    return _STATE


@contextlib.contextmanager
def axis_rules(mesh, rules: Dict[str, Axis]):
    """Install (mesh, logical→mesh-axis rules) for the enclosed code."""
    st = _st()
    old = (st.mesh, st.rules)
    st.mesh, st.rules = mesh, dict(rules)
    try:
        yield
    finally:
        st.mesh, st.rules = old


def current_mesh():
    return _st().mesh


def spec_for(names: Sequence[Union[str, None]]) -> Tuple[Axis, ...]:
    st = _st()
    return tuple(st.rules.get(n) if isinstance(n, str) else None
                 for n in names)


def placements(mesh, spec: Sequence[Axis]) -> tuple:
    """DTensor placements on ``mesh`` of a ``spec_for`` tuple."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * mesh.ndim
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry,) if isinstance(entry, str) else entry:
            out[mesh.mesh_dim_names.index(axis)] = Shard(dim)
    return tuple(out)


def sharding_for(names: Sequence[Union[str, None]]) -> Optional[tuple]:
    st = _st()
    if st.mesh is None:
        return None
    return placements(st.mesh, spec_for(names))


def distribute(x, mesh, where: tuple):
    """A tensor every rank holds whole → its DTensor with placements
    ``where`` (each rank keeps its own shard; nothing is sent)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, mesh, list(where), src_data_rank=None)


def shard(x, *names: Union[str, None]):
    """Constrain ``x``'s sharding by logical axis names (no-op w/o mesh)."""
    st = _st()
    if st.mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    where = placements(st.mesh, spec_for(names))
    if not isinstance(x, DTensor):
        return distribute(x, st.mesh, where)
    if tuple(x.placements) == where:
        return x
    return x.redistribute(st.mesh, where)


def _is_spec(x) -> bool:
    """A spec-tree leaf: a tuple of logical names (not a container)."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        n is None or isinstance(n, str) for n in x)


def _spec_leaves(spec_tree):
    """A spec tree's tuples in the order its tensors' leaves come."""
    if _is_spec(spec_tree):
        return [spec_tree]
    if isinstance(spec_tree, dict):
        return [s for k in sorted(spec_tree)
                for s in _spec_leaves(spec_tree[k])]
    return [s for child in spec_tree for s in _spec_leaves(child)]


def _map_specs(fn, spec_tree):
    if _is_spec(spec_tree):
        return fn(spec_tree)
    if isinstance(spec_tree, dict):
        return {k: _map_specs(fn, v) for k, v in spec_tree.items()}
    return type(spec_tree)(_map_specs(fn, v) for v in spec_tree)


def tree_shardings(spec_tree, mesh=None):
    """Map a tree of logical-name tuples to DTensor placements."""
    mesh = mesh or _st().mesh
    if mesh is None:
        raise ValueError("tree_shardings requires a mesh")
    return _map_specs(lambda names: placements(mesh, spec_for(names)),
                      spec_tree)


def tree_distribute(tree, shardings, mesh=None):
    """A tree every rank holds whole → DTensors placed by ``shardings``
    (a tree of placements, ``tree_shardings``' output, with the
    structure of ``tree``); each rank keeps its own shards. The
    analogue of ``jax.device_put(tree, shardings)``."""
    mesh = mesh or _st().mesh
    if mesh is None:
        raise ValueError("tree_distribute requires a mesh")
    flat = [leaf for _, leaf in flatten_with_path(tree)]
    where = _placement_leaves(shardings)
    if len(where) != len(flat):
        raise ValueError(f"tree_distribute: {len(flat)} leaves, "
                         f"{len(where)} shardings")
    return unflatten_like(tree, [distribute(x, mesh, w)
                                 for x, w in zip(flat, where)])


def _placement_leaves(tree):
    """A placements tree's tuples of ``Placement`` in leaf order."""
    from torch.distributed.tensor import Placement

    if isinstance(tree, tuple) and tree and \
            all(isinstance(p, Placement) for p in tree):
        return [tree]
    if isinstance(tree, dict):
        return [w for k in sorted(tree) for w in _placement_leaves(tree[k])]
    if hasattr(tree, "_fields"):
        return [w for f in tree._fields
                for w in _placement_leaves(getattr(tree, f))]
    return [w for child in tree for w in _placement_leaves(child)]


def tree_shard_like(tree, spec_tree):
    """Constrain a tree's shardings by a tree of logical-name tuples
    (no-op without an installed mesh). ``spec_tree`` leaves are tuples
    of logical names, matched against ``tree``'s tensor leaves."""
    if _st().mesh is None:
        return tree
    flat = [leaf for _, leaf in flatten_with_path(tree)]
    specs = _spec_leaves(spec_tree)
    if len(specs) != len(flat):
        raise ValueError(f"tree_shard_like: {len(flat)} leaves, "
                         f"{len(specs)} specs")
    return unflatten_like(tree, [shard(x, *names)
                                 for x, names in zip(flat, specs)])
