"""The port's device mesh and the machinery its sharded forms share.

The JAX package shards over a ``jax.sharding.Mesh``: one process owns a
grid of devices whose axes have names, and a ``PartitionSpec`` says
which axes a dimension splits over. The port does the same in one
process over a grid of ``torch.device``\\ s:

- :class:`Mesh` is the grid, built from a numpy array of devices and
  axis names. Devices may repeat: ``Mesh(np.array(['cuda:0'] * 4),
  ('pools',))`` is four shards on one card, ``['cpu'] * 8`` eight
  shards on the CPU.
- A *placement* is a tuple with one entry per dimension, the
  counterpart of a ``PartitionSpec``: ``()`` replicates, ``(axes,)``
  splits dim 0 over the mesh axes ``axes``, ``(axes, None)`` splits the
  rows of a matrix, ``(None, axes)`` the columns of a [T, P] window.
- A *sharded tree* is a tuple of per-shard trees (NamedTuples and
  dicts of tensors) of one type, in shard order. Shard ``i`` holds the
  ``i``-th contiguous block of the split dimension on the ``i``-th
  device of the grid in the row-major order of ``axes``, which is the
  layout ``P(('host', 'chip'))`` gives in JAX. A replicated leaf is
  copied to every shard's device.
- :class:`Reducer` is the all-reduce: each shard's partials go to the
  mesh's first device, are reduced there, and the result is copied
  back to each shard's device. The **flat** form reduces the shards in
  one pass, as GSPMD's single all-reduce does; the **hierarchical**
  form reduces the innermost axis first, then the outer ones, as the
  ``shard_map`` forms do with ``psum`` over ``reversed(axes)``.

The collectives are plain tensor copies, not ``torch.distributed`` or
DTensor: the FIR kernel is a ``ctypes`` launch on raw pointers, so
each shard must be an ordinary contiguous tensor on its device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ['Mesh', 'Reducer', 'replicate', 'shard_rows', 'shard_tree',
           'tree_map', 'tree_map_with_path', 'unshard']


def _as_device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('a Mesh names %s and no CUDA device is '
                               'available' % dev)
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError('a Mesh names %s and only %d CUDA devices '
                               'exist' % (dev, torch.cuda.device_count()))
    return dev


class Mesh:
    """A named grid of ``torch.device``\\ s, the counterpart of
    ``jax.sharding.Mesh``: ``devices`` (a numpy object array of the
    grid's shape), ``axis_names``, ``shape`` (axis name -> size) and
    ``size`` (the number of shards, repeated devices counted)."""

    def __init__(self, devices, axis_names):
        grid = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names) or grid.size == 0:
            raise ValueError('a Mesh needs a non-empty grid with one axis '
                             'name per dimension, got shape %s and names %r'
                             % (grid.shape, axis_names))
        if len(set(axis_names)) != len(axis_names):
            raise ValueError('repeated mesh axis name in %r' % (axis_names,))
        out = np.empty(grid.shape, dtype=object)
        for idx, d in np.ndenumerate(grid):
            out[idx] = _as_device(d)
        self.devices = out
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, grid.shape))
        self.size = int(grid.size)

    def __repr__(self):
        return 'Mesh(%s, %r)' % (
            [str(d) for d in self.devices.flat], self.axis_names)

    def shard_devices(self, axes) -> list:
        """The devices of the shards when a dimension splits over
        ``axes`` (which must name every mesh axis once), in shard
        order: the grid transposed to ``axes`` order, row-major."""
        axes = _axes(axes)
        if sorted(axes) != sorted(self.axis_names):
            raise ValueError('a dimension shards over every mesh axis; '
                             'got %r on a mesh with axes %r'
                             % (axes, self.axis_names))
        order = [self.axis_names.index(a) for a in axes]
        return list(self.devices.transpose(order).flat)

    @property
    def first_device(self) -> torch.device:
        return self.devices.flat[0]


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


# -- trees ------------------------------------------------------------------

def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` (NamedTuples, tuples
    and dicts of tensors), with the matching nodes of ``rest`` (the
    same structure, whatever their leaves) as further arguments."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*vals) if hasattr(tree, '_fields') else tuple(vals)
    raise TypeError('not a tree of tensors: %r' % type(tree))


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over the tensor leaves of ``tree``, where
    ``path`` is the tuple of keys from the root: NamedTuple field names,
    dict keys, and the indices of plain tuples."""
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        names = getattr(tree, '_fields', None) or range(len(tree))
        vals = [tree_map_with_path(fn, v, path + (k,))
                for k, v in zip(names, tree)]
        return type(tree)(*vals) if hasattr(tree, '_fields') else tuple(vals)
    raise TypeError('not a tree of tensors: %r' % type(tree))


def _split_dim(spec) -> tuple:
    """(dim, axes) of the one split dimension of a placement, or
    (None, None) for a replicated one."""
    split = [(d, e) for d, e in enumerate(spec) if e is not None]
    if not split:
        return None, None
    if len(split) > 1:
        raise ValueError('a placement splits one dimension, got %r'
                         % (spec,))
    return split[0]


def shard_rows(t: torch.Tensor, mesh: Mesh, axes, dim: int = 0) -> list:
    """``t`` split along ``dim`` into ``mesh.size`` contiguous blocks,
    block ``i`` on the ``i``-th shard device of ``axes``. A block that
    is already on its device is a view of ``t``, as ``Tensor.to``
    leaves it."""
    devs = mesh.shard_devices(axes)
    n = len(devs)
    if t.shape[dim] % n:
        raise ValueError('cannot split %d rows over %d shards'
                         % (t.shape[dim], n))
    size = t.shape[dim] // n
    return [t.narrow(dim, i * size, size).to(d) for i, d in enumerate(devs)]


def replicate(t: torch.Tensor, devices) -> list:
    """``t`` on each of ``devices`` (no copy where it already is)."""
    return [t.to(d) for d in devices]


def shard_tree(tree, specs, mesh: Mesh) -> tuple:
    """A tree placed on the mesh: a tuple of ``mesh.size`` per-shard
    trees, each leaf split or replicated as its placement in ``specs``
    (a tree of the same structure) says. Every split leaf splits over
    the same mesh axes, which also order the replicas."""
    split = {_axes(axes) for _, axes in
             (_split_dim(spec) for _, spec in _spec_leaves(tree, specs))
             if axes is not None}
    if len(split) > 1:
        raise ValueError('one tree splits over one ordering of the mesh '
                         'axes, got %r' % sorted(split))
    devs = mesh.shard_devices(split.pop() if split else mesh.axis_names)

    def place(leaf, spec):
        dim, axes = _split_dim(spec)
        if dim is None:
            return replicate(leaf, devs)
        return shard_rows(leaf, mesh, axes, dim)
    placed = tree_map(place, tree, specs)
    return tuple(tree_map(lambda leaf, blocks, i=i: blocks[i], tree, placed)
                 for i in range(mesh.size))


def _spec_leaves(tree, specs):
    """(leaf, placement) pairs of a tree and its placement tree."""
    out = []
    tree_map(lambda leaf, spec: out.append((leaf, spec)), tree, specs)
    return out


def unshard(shards, specs=None, device=None):
    """The global tree of a sharded tree, on ``device`` (default: shard
    0's device of each leaf): split leaves concatenated in shard order,
    replicated leaves taken from shard 0. Without ``specs``, rank-0
    leaves are replicated and the rest split along dim 0. One copy per
    shard per leaf, so ``device='cpu'`` gathers with one host copy per
    shard."""
    if specs is None:
        # Any axis name will do: only which dimension splits matters.
        specs = tree_map(lambda leaf: () if leaf.dim() == 0 else ('rows',),
                         shards[0])

    def gather(leaf0, spec, *rest):
        dev = leaf0.device if device is None else torch.device(device)
        dim, _ = _split_dim(spec)
        if dim is None:
            return leaf0.to(dev)
        return torch.cat([x.to(dev) for x in (leaf0,) + rest], dim)
    return tree_map(gather, shards[0], specs, *shards[1:])


# -- the all-reduce ---------------------------------------------------------

class Reducer:
    """The all-reduce over the shards of ``axes`` on ``mesh``:
    :meth:`total` reduces one value per shard onto the mesh's first
    device, :meth:`broadcast` copies a value to each shard's device,
    and :meth:`all_reduce` is the two. ``hierarchical`` reduces the
    innermost axis of ``axes`` first, then the outer ones; otherwise
    the shards reduce in one pass."""

    def __init__(self, mesh: Mesh, axes, hierarchical: bool = False):
        axes = _axes(axes)
        self.devices = mesh.shard_devices(axes)
        self.first = mesh.first_device
        self.grid = tuple(mesh.shape[a] for a in axes)
        self.hierarchical = hierarchical

    def total(self, values: list, op: str = 'sum') -> torch.Tensor:
        if len(values) != len(self.devices):
            raise ValueError('%d values for %d shards'
                             % (len(values), len(self.devices)))
        x = torch.stack([v.to(self.first) for v in values])
        if self.hierarchical:
            # Innermost axis first: reduce the last grid dimension
            # until none is left.
            x = x.reshape(self.grid + x.shape[1:])
            for dim in reversed(range(len(self.grid))):
                x = _reduce_dim(x, dim, op)
            return x
        return _reduce_dim(x, 0, op)

    def broadcast(self, value: torch.Tensor) -> list:
        return replicate(value, self.devices)

    def all_reduce(self, values: list, op: str = 'sum') -> list:
        return self.broadcast(self.total(values, op))

    def totals(self, parts: list, max_terms=()) -> dict:
        """Per-shard dicts of partials reduced term by term onto the
        first device: max for the names in ``max_terms``, sum for the
        rest."""
        return {k: self.total([p[k] for p in parts],
                              'max' if k in max_terms else 'sum')
                for k in parts[0]}

    def broadcast_terms(self, terms: dict) -> list:
        """A dict of tensors as one dict per shard, on its device."""
        out = {k: self.broadcast(v) for k, v in terms.items()}
        return [{k: v[i] for k, v in out.items()}
                for i in range(len(self.devices))]

    def terms(self, parts: list, max_terms=()) -> list:
        """:meth:`totals` copied back to every shard: the all-reduce of
        a dict of partials."""
        return self.broadcast_terms(self.totals(parts, max_terms))


def _reduce_dim(x: torch.Tensor, dim: int, op: str) -> torch.Tensor:
    if op == 'sum':
        return torch.sum(x, dim, dtype=x.dtype)
    if op == 'max':
        return torch.amax(x, dim)
    raise ValueError('unknown reduction %r' % op)
