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
seeded pipeline, or a result that every rank computed alike), into its
local shard without communication. :func:`unshard`,
:func:`local_part`/:func:`from_local_part` and :func:`elementwise` carry
a computation that DTensor has no sharding rule for (a sort dispatch,
``logsigmoid``'s backward) across plain tensors, on the autograd graph.
"""
from __future__ import annotations

import contextlib
import functools
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


def carry_rules(fn):
    """``fn`` wrapped so that each call, on whatever thread makes it,
    runs under the mesh and rule table installed when ``carry_rules``
    is called. The table is thread-local, and the autograd engine runs
    a CUDA backward — a rematerialised block's recomputation with it —
    on a thread of its own, where no table is installed (on the CPU the
    backward runs on the caller's thread). Without a mesh: ``fn``."""
    st = _st()
    mesh, rules = st.mesh, st.rules
    if mesh is None:
        return fn

    def call(*args, **kwargs):
        with axis_rules(mesh, rules):
            return fn(*args, **kwargs)

    return call


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
    ``where``, each rank keeping its own shard (nothing is sent). It
    stays on the autograd graph: the gradient of the shards flows back
    to ``x``."""
    from torch.distributed.tensor import DTensor, Replicate

    whole = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return whole.redistribute(mesh, where)


def shard(x, *names: Union[str, None]):
    """Constrain ``x``'s sharding by logical axis names (no-op w/o mesh).
    A dimension whose size its mesh axes do not divide stays whole
    (the rule table's graceful degradation, applied at the tensor: the
    reference's ``ff`` and ``lstm_dh`` rules shard without a size
    check, and an uneven DTensor shard of an activation cannot be
    reshaped)."""
    st = _st()
    if st.mesh is None:
        return x
    spec = tuple(None if entry is not None and dim < x.dim() and
                 x.shape[dim] % _axes_size(st.mesh, entry) else entry
                 for dim, entry in enumerate(spec_for(names)))
    return _constrain(x, st.mesh, placements(st.mesh, spec))


def _axes_size(mesh, entry: Axis) -> int:
    n = 1
    for axis in (entry,) if isinstance(entry, str) else entry:
        n *= mesh.size(mesh.mesh_dim_names.index(axis))
    return n


def _constrain(x, mesh, where: tuple):
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return distribute(x, mesh, where)
    if tuple(x.placements) == where:
        return x
    return x.redistribute(mesh, where)


def gather_seq(x):
    """``x`` (B, S, ...) laid out by batch alone: the sequence gathered
    whole, as Megatron's sequence parallelism gathers a block's input
    before its column-parallel products (and XLA's propagation does for
    the reference). A product over a sequence still split would merge
    (B, S) into one strided shard, which DTensor can lay out only by a
    search that grows with the mesh's rank. No-op without a mesh."""
    if _st().mesh is None:
        return x
    return shard(x, "batch", *([None] * (x.dim() - 1)))


def unshard(x, rows: Sequence[Union[str, None]] = ()):
    """The whole of ``x`` on every rank, as a plain tensor (an
    all-gather of a DTensor's shards, a sum of its partial values; on
    the autograd graph). A plain tensor, or any tensor without a mesh,
    is returned as it is. For a computation that DTensor has no
    sharding rule for: it runs on plain tensors, and its result goes
    back through :func:`shard` or :func:`from_local_part`.

    ``rows``: the logical names of the axes along which that
    computation runs on each rank's own rows (``("batch",)`` for one
    on :func:`local_part` blocks). Along their mesh axes each rank's
    gradient of ``x`` is a partial sum, and is summed there; elsewhere
    every rank computes the same gradient. Empty (the default): the
    computation runs alike on every rank (the MoE's global sort
    dispatch)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if _st().mesh is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    summed = set()
    for entry in spec_for(rows):
        if entry is not None:
            summed.update((entry,) if isinstance(entry, str) else entry)
    grads = [Partial() if name in summed else Replicate()
             for name in mesh.mesh_dim_names]
    return _contiguous_grad(x.redistribute(
        mesh, [Replicate()] * mesh.ndim).to_local(grad_placements=grads))


def local_part(x, *names: Union[str, None]):
    """This rank's block of ``x`` laid out by logical ``names``, as a
    plain tensor (``x`` is redistributed there first; on the autograd
    graph). Without a mesh: ``x``. The way into a computation that is
    local to each block along those names (the MoE's grouped dispatch,
    whose groups follow ``batch``); :func:`from_local_part` is the way
    back out. The names' mesh axes must divide their dims evenly."""
    st = _st()
    if st.mesh is None:
        return x
    for dim, entry in enumerate(spec_for(names)):
        if entry is not None and x.shape[dim] % _axes_size(st.mesh, entry):
            raise ValueError(
                f"local_part: dim {dim} ({x.shape[dim]}) does not divide "
                f"over the mesh axes {entry}")
    return _contiguous_grad(shard(x, *names).to_local())


def _contiguous_grad(x):
    """``x`` whose gradient is made contiguous on its way back: a plain
    region's gradient can come out strided (a product's transpose),
    and DTensor then views its shards as if they were contiguous."""
    return _ContiguousGrad().apply(x) if x.requires_grad else x


@functools.lru_cache(maxsize=None)
def _ContiguousGrad():
    import torch

    class ContiguousGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t.view_as(t)

        @staticmethod
        def backward(ctx, g):
            return g.contiguous()

    return ContiguousGrad


def blockwise(fn, acts, weights=(), out=()):
    """``fn(*acts, *weights)`` run on plain tensors, each rank on its
    own block of rows: ``acts`` are (tensor, logical names) pairs of
    activations, cut to their blocks by :func:`local_part`;
    ``weights`` are tensors read whole (their gradients summed over
    the ``batch`` axes); the result is laid out by the names ``out``
    (:func:`from_local_part`; a tuple of such name tuples for a tuple
    of results). For a computation independent across rows that
    DTensor lays out poorly or not at all (a lookup, a pad along a
    whole dim, a causal conv, a chunked scan's cumulative sums).
    Without a mesh: ``fn`` on the tensors as they are."""
    if _st().mesh is None:
        return fn(*[a for a, _ in acts], *weights)
    parts = [local_part(a, *names) for a, names in acts] + \
        [unshard(w, rows=("batch",)) for w in weights]
    with axis_rules(None, {}):
        res = fn(*parts)
    if isinstance(res, tuple):
        return tuple(from_local_part(r, *names) for r, names in
                     zip(res, out))
    return from_local_part(res, *out)


def from_local_part(x, *names: Union[str, None]):
    """The DTensor whose block on this rank is ``x``, laid out by
    logical ``names`` (every rank calls it with its own block; on the
    autograd graph). Without a mesh: ``x``."""
    st = _st()
    if st.mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x, st.mesh,
                              placements(st.mesh, spec_for(names)),
                              run_check=False)


def _reshape_groups(src, dst):
    """Pair the dims of two shapes of one size into groups whose
    products agree: [(input dims, output dims), ...]."""
    groups, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        gi, gj = [], []
        a = b = 1
        while True:
            if a <= b and i < len(src):
                a *= src[i]
                gi.append(i)
                i += 1
            elif j < len(dst):
                b *= dst[j]
                gj.append(j)
                j += 1
            else:
                break
            if a == b and (i == len(src) or src[i] != 1) and \
                    (j == len(dst) or dst[j] != 1):
                break
        groups.append((gi, gj))
    return groups


def reshape(x, *shape: int):
    """``x.reshape(shape)`` that a DTensor can always take. DTensor
    lays a reshape out only where each sharded input dim is the first
    of the dims it merges with, and its shard count divides both its
    own size and the first output dim it splits into; any other
    sharded dim is gathered first, and the gradient is brought back to
    the output's layout before the reshape's backward. A plain tensor
    is reshaped as ``Tensor.reshape`` does it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    src = tuple(x.shape)
    n = 1
    for d in src:
        n *= d
    dst = list(shape)
    if -1 in dst:
        k = dst.index(-1)
        rest = 1
        for j, d in enumerate(dst):
            if j != k:
                rest *= d
        dst[k] = n // max(rest, 1)
    mesh = x.device_mesh
    where = list(x.placements)
    for gi, gj in _reshape_groups(src, tuple(dst)):
        for i in gi:
            axes = [a for a, p in enumerate(where)
                    if isinstance(p, Shard) and p.dim == i]
            if not axes or src[i] == dst[gj[0]] and len(gi) == len(gj) == 1:
                continue
            count = 1
            for a in axes:
                count *= mesh.size(a)
            if i != gi[0] or src[i] % count or (gj and dst[gj[0]] % count):
                for a in axes:
                    where[a] = Replicate()
    if tuple(where) != tuple(x.placements):
        x = x.redistribute(mesh, where)
    out = x.reshape(*dst)
    # the gradient comes back in the layout the forward gave ``out``,
    # which the reshape's own backward lays out (a gradient split
    # otherwise would reach it as a strided shard)
    return out.redistribute(mesh, out.placements)


def elementwise(fn, x):
    """``fn`` — an elementwise function DTensor has no sharding rule
    for (``logsigmoid``'s backward) — applied to each rank's block of
    ``x``. A DTensor's pending sums are reduced first; its shards and
    replicas keep their layout. A plain tensor goes straight to
    ``fn``."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return fn(x)
    mesh = x.device_mesh
    where = tuple(Replicate() if p.is_partial() else p
                  for p in x.placements)
    if where != tuple(x.placements):
        x = x.redistribute(mesh, where)
    return DTensor.from_local(fn(x.to_local()), mesh, where,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


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
    mesh = _st().mesh
    return unflatten_like(tree, [
        _constrain(x, mesh, placements(mesh, spec_for(names)))
        for x, names in zip(flat, specs)])
