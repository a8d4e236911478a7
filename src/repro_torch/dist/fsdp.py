"""FSDP x TP under the single controller: the mesh's rows and columns,
the gathers that assemble a layer's weights where a shard computes with
them, the copies between shards, and the accounting the dry-run reads.

One process drives every shard, as :class:`~repro_torch.dist.serve.
ServeMesh` does for serving.  A mesh's devices (which may repeat) form
``rows`` (every axis but the tensor-parallel one: the data rows, which
take slices of the batch) by ``cols`` (the tensor-parallel axis).  The
state is stored as :class:`~repro_torch.dist.sharding.Sharded` blocks;
:meth:`Row.gather` assembles what device (row, column) computes with: the
blocks along every axis but the kept one (the FSDP all-gather over the
data axis) concatenated, the column's own block along the kept one.
Every copy between shards goes through :func:`move`, so that the
backward's collectives are autograd's: the gradient of a gather is a
split (the reduce-scatter), the gradient of a copy to several shards a
sum.

Two mechanisms keep memory at the one-device step's:

- :class:`Regather` packs a saved gathered weight as the recipe that
  gathers it, and gathers it again in the backward, so no layer's
  gathered weights outlive its forward (the backward of a matmul needs
  its weight; without this every data row would hold a whole copy of the
  params until the backward);
- under ``remat`` the gathers sit inside the checkpointed region and are
  recomputed with it.

:class:`Accounting` (a ``TorchDispatchMode``) attributes every op to the
shard it runs for: its FLOPs (``torch.utils.flop_counter``'s formulas),
the bytes of the tensors it makes (live and peak), and, through
:func:`move`, the bytes each shard receives.  With meta tensors it costs
no memory, which is how :mod:`repro_torch.launch.dryrun` accounts a step
over 256 devices on a host with no card.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.roofline import FLASH_INNER, current_scope
from repro_torch.dist.sharding import (Sharded, mesh_coords, mesh_index,
                                       spec_axes)


def _accounting() -> Optional["Accounting"]:
    """The innermost active :class:`Accounting`, if any."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, Accounting):
            return mode
    return None


@contextlib.contextmanager
def on(k: int):
    """Under an accounting, attribute the ops made inside that have no
    input to inherit a shard from (creation ops) to shard ``k``."""
    acct = _accounting()
    if acct is None:
        yield
        return
    prev, acct.current = acct.current, k
    try:
        yield
    finally:
        acct.current = prev


# ---------------------------------------------------------------------------
# the mesh as rows x columns
# ---------------------------------------------------------------------------

class MeshPlan:
    """``mesh`` as ``rows`` x ``cols``: the columns run along ``tp_axis``
    (1 when the mesh has no such axis), the rows over every other axis in
    the mesh's order."""

    def __init__(self, mesh, tp_axis: str = "model"):
        self.mesh = mesh
        self.tp_axis = tp_axis
        self.cols = int(mesh.shape.get(tp_axis, 1))
        self.rows = len(mesh.devices) // self.cols
        self.row_axes = [(a, s) for a, s in zip(mesh.axis_names, mesh.sizes)
                         if a != tp_axis]

    def row_coords(self, r: int) -> Dict[str, int]:
        out = {}
        for a, s in reversed(self.row_axes):
            out[a] = r % s
            r //= s
        return out

    def index(self, r: int, c: int) -> int:
        """The flat mesh index of row r, column c."""
        coords = self.row_coords(r)
        coords[self.tp_axis] = c
        return mesh_index(self.mesh, coords)

    def device(self, k: int) -> torch.device:
        return self.mesh.devices[k]

    def batch_rows(self, axes) -> List[tuple]:
        """[(row, block, blocks)]: the rows that compute and the batch
        block each takes when the batch splits over mesh ``axes`` (from
        the policy's batch rule; ``()`` replicates it, computed once by
        row 0).  Rows that differ only along axes the batch does not
        split over would compute the same slice: only the first does."""
        sizes = self.mesh.shape
        n = 1
        for a in axes:
            n *= sizes[a]
        out = []
        for r in range(self.rows):
            co = self.row_coords(r)
            if any(v and a not in axes for a, v in co.items()):
                continue
            b = 0
            for a in axes:
                b = b * sizes[a] + co[a]
            out.append((r, b, n))
        return out


# ---------------------------------------------------------------------------
# copies between shards
# ---------------------------------------------------------------------------

class _Move(torch.autograd.Function):
    """A copy from shard ``src`` to shard ``dst`` that the accounting
    sees: the forward's bytes arrive at ``dst``, the backward's (the
    gradient going home) at ``src``."""

    @staticmethod
    def forward(ctx, t, acct, src, dst, dst_dev, src_dev):
        ctx.acct, ctx.src, ctx.src_dev = acct, src, src_dev
        return acct.receive(t, dst, dst_dev)

    @staticmethod
    def backward(ctx, g):
        return (ctx.acct.receive(g, ctx.src, ctx.src_dev),) + (None,) * 5


def move(t: torch.Tensor, mesh, src: int, dst: int) -> torch.Tensor:
    """``t`` (held by shard ``src``) as shard ``dst`` holds it; the same
    tensor when the shards are one, or share a device (no copy is
    made), unless an accounting counts the copy a mesh of distinct
    devices would make."""
    if src == dst:
        return t
    acct = _accounting()
    if acct is not None:
        return _Move.apply(t, acct, src, dst, mesh.devices[dst],
                           mesh.devices[src])
    return t.to(mesh.devices[dst])


class _Gathered(torch.autograd.Function):
    """A gather as the accounting sees it, one op: a tensor of the
    result's shape on ``dst``, the bytes of the blocks other shards hold
    received there; its backward hands each block its gradient, a view of
    the incoming one where ``dst`` holds the block, else a copy received
    by the block's owner.  (Tracing a 256-device mesh gathers every leaf
    from 16 blocks on every shard; one op each keeps the trace short.)"""

    @staticmethod
    def forward(ctx, acct, info, *blocks):
        shape, dst, dst_dev, owners, devs, offsets = info
        ctx.acct, ctx.info = acct, info
        ctx.shapes = [tuple(b.shape) for b in blocks]
        for b, o in zip(blocks, owners):
            if o != dst:
                acct.recv[dst] += b.numel() * b.element_size()
        with acct.forced_to(dst):
            return torch.empty(shape, dtype=blocks[0].dtype, device=dst_dev)

    @staticmethod
    def backward(ctx, g):
        _, dst, _, owners, devs, offsets = ctx.info
        acct = ctx.acct
        out = []
        for shp, o, dev, off in zip(ctx.shapes, owners, devs, offsets):
            view = g.as_strided(shp, g.stride(), off)
            if o == dst:
                out.append(view)
            else:
                out.append(acct.receive(view, o, dev))
        return (None, None, *out)


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


# ---------------------------------------------------------------------------
# gathers, and gathering again in the backward
# ---------------------------------------------------------------------------

def gather(x, mesh, dst: int, keep: Optional[str] = None,
           layer: Optional[int] = None) -> torch.Tensor:
    """What shard ``dst`` computes with of leaf ``x``: layer ``layer`` of
    it (its leading LAYERS axis indexed, None: all of it), concatenated
    from the blocks along every dimension, except that along a dimension
    the spec splits over the mesh axis ``keep`` only ``dst``'s own block
    is taken.  A plain tensor is one block held by shard 0."""
    if not isinstance(x, Sharded):
        return move(x if layer is None else x[layer], mesh, 0, dst)
    grid = x.grid
    co = mesh_coords(mesh, dst)
    sizes = mesh.shape
    fixed = []
    for e in x.spec:
        axes = spec_axes(e)
        if axes and keep is not None and axes == (keep,):
            fixed.append(co[keep])
        elif axes and keep is not None and keep in axes:
            b = 0                       # a dimension split over keep and more
            for a in axes:
                b = b * sizes[a] + co[a]
            fixed.append(b)
        else:
            fixed.append(None)
    shift = 0 if layer is None else 1
    acct = _accounting()
    if acct is not None:
        return _gathered(acct, x, mesh, dst, fixed, layer)

    def build(prefix):
        d = len(prefix)
        if d == len(grid):
            i = 0
            for g, b in zip(grid, prefix):
                i = i * g + b
            blk = x.blocks[i] if layer is None else x.blocks[i][layer]
            return move(blk, mesh, x.owners[i], dst)
        if fixed[d] is not None:
            return build(prefix + (fixed[d],))
        parts = [build(prefix + (j,)) for j in range(grid[d])]
        return (parts[0] if len(parts) == 1
                else torch.cat(parts, dim=d - shift))

    return build(())


def _gathered(acct, x: Sharded, mesh, dst: int, fixed, layer):
    """:func:`gather` under the accounting, as one :class:`_Gathered`."""
    import itertools
    grid = x.grid
    picks = [range(g) if f is None else [f] for g, f in zip(grid, fixed)]
    coords = list(itertools.product(*picks))
    idx = []
    for c in coords:
        i = 0
        for g, b in zip(grid, c):
            i = i * g + b
        idx.append(i)
    blocks = [x.blocks[i] if layer is None else x.blocks[i][layer]
              for i in idx]
    if len(blocks) == 1:
        return move(blocks[0], mesh, x.owners[idx[0]], dst)
    full = list(x.shape[1:] if layer is not None else x.shape)
    dims = grid[1:] if layer is not None else grid
    fx = fixed[1:] if layer is not None else fixed
    shape = [n // g if f is not None else n
             for n, g, f in zip(full, dims, fx)]
    strides = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        strides[d] = strides[d + 1] * shape[d + 1]
    lead = 1 if layer is not None else 0
    offsets = []
    for c in coords:
        off = 0
        for d, (b, f) in enumerate(zip(c[lead:], fx)):
            if f is None:
                off += b * (full[d] // dims[d]) * strides[d]
        offsets.append(off)
    info = (tuple(shape), dst, mesh.devices[dst],
            [x.owners[i] for i in idx], [mesh.devices[x.owners[i]]
                                         for i in idx], offsets)
    return _Gathered.apply(acct, info, *blocks)


_TOKEN = object()


class Regather:
    """``torch.autograd.graph.saved_tensors_hooks`` that save a gathered
    weight (or a view of one) as the recipe that gathers it: the
    backward gathers it again from the blocks, which the step leaves
    untouched until the optimizer runs."""

    def __init__(self):
        self._made: Dict[int, tuple] = {}

    def note(self, t: torch.Tensor, recipe) -> torch.Tensor:
        self._made[_storage_key(t)] = (weakref.ref(t), recipe)
        return t

    def _pack(self, t):
        if not isinstance(t, torch.Tensor) or t.layout != torch.strided:
            return t
        ent = self._made.get(_storage_key(t))
        if ent is None or ent[0]() is None:
            return t
        return (_TOKEN, ent[1], tuple(t.shape), t.stride(),
                t.storage_offset())

    @staticmethod
    def _unpack(x):
        if isinstance(x, tuple) and len(x) == 5 and x[0] is _TOKEN:
            _, recipe, shape, stride, offset = x
            with torch.no_grad():
                base = recipe()
            return base.as_strided(shape, stride, offset)
        return x

    @contextlib.contextmanager
    def active(self):
        with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                      self._unpack):
            yield self


class Row:
    """One data row's view of the stored state: :meth:`gather` assembles
    a leaf where column ``c`` computes with it (noting it for
    :class:`Regather` when the gather made a new tensor)."""

    def __init__(self, plan: MeshPlan, r: int, regather: Optional[Regather]):
        self.plan = plan
        self.r = r
        self.cols = [plan.index(r, c) for c in range(plan.cols)]
        self.devs = [plan.device(k) for k in self.cols]
        self.home = self.cols[0]
        self.regather = regather

    def gather(self, x, c: int = 0, keep: bool = True,
               layer: Optional[int] = None) -> torch.Tensor:
        mesh, dst = self.plan.mesh, self.cols[c]
        axis = self.plan.tp_axis if keep else None
        t = gather(x, mesh, dst, axis, layer)
        if self.regather is not None and isinstance(t, torch.Tensor):
            src = x.blocks if isinstance(x, Sharded) else [x]
            if all(_storage_key(t) != _storage_key(b) for b in src):
                self.regather.note(
                    t, lambda: gather(x, mesh, dst, axis, layer))
        return t

    def move(self, t, src_c: int, dst_c: int) -> torch.Tensor:
        return move(t, self.plan.mesh, self.cols[src_c], self.cols[dst_c])


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

class Accounting(TorchDispatchMode):
    """Per-shard FLOPs, bytes read and written (each op's inputs and
    outputs once; views and in-place aliases move none), bytes received,
    and live/peak bytes of the tensors the traced ops make.  An op
    belongs to the shard of its first input whose shard is known, else
    to the shard :func:`on` names; a :func:`move`'s copy belongs to its
    destination.  Tensors that exist
    before the trace (the step's arguments) are :meth:`register`-ed with
    their shard; their bytes are the caller's baseline.  ``flash_inner``
    is the share of ``bytes`` of the ops issued inside a
    :func:`~repro_torch.core.roofline.named_scope` of that name."""

    def __init__(self, shards: int):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop = flop_registry
        self.flops = [0] * shards
        self.bytes = [0] * shards
        self.recv = [0] * shards
        self.live = [0] * shards
        self.peak = [0] * shards
        self.flash_inner = [0] * shards
        self._owner: Dict[int, int] = {}
        self._forced: Optional[int] = None
        self.current = 0            # the shard of ops with no known input

    def register(self, t: torch.Tensor, shard: int) -> None:
        self._track(t, shard, count=False)

    def _drop(self, key, shard, nbytes):
        self._owner.pop(key, None)
        self.live[shard] -= nbytes

    def _track(self, t, shard, count):
        key = id(t)
        if key in self._owner:
            return
        self._owner[key] = shard
        nbytes = t.numel() * t.element_size() if count else 0
        if nbytes:
            self.live[shard] += nbytes
            self.peak[shard] = max(self.peak[shard], self.live[shard])
        weakref.finalize(t, self._drop, key, shard, nbytes)

    @contextlib.contextmanager
    def forced_to(self, k: int):
        """Attribute the ops made inside to shard ``k``."""
        prev, self._forced = self._forced, k
        try:
            yield
        finally:
            self._forced = prev

    def receive(self, t, dst: int, device) -> torch.Tensor:
        self.recv[dst] += t.numel() * t.element_size()
        with self.forced_to(dst):
            return t.to(device, copy=True)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = list(_tensors(args)) + list(_tensors(kwargs.values()))
        shard = self._forced
        if shard is None:
            for a in ins:
                if id(a) in self._owner:
                    shard = self._owner[id(a)]
                    break
        if shard is None:
            shard = self.current
        packet = func._overloadpacket
        if packet in self._flop:
            self.flops[shard] += int(self._flop[packet](*args, **kwargs,
                                                        out_val=out))
        aliasing = any(r.alias_info is not None
                       for r in func._schema.returns)
        outs = list(_tensors(out if isinstance(out, (list, tuple))
                             else (out,)))
        for o in outs:
            self._track(o, shard, count=not aliasing)
        if not aliasing:
            moved = sum(t.numel() * t.element_size() for t in ins + outs)
            self.bytes[shard] += moved
            if current_scope() == FLASH_INNER:
                self.flash_inner[shard] += moved
        return out


def _tensors(xs):
    """The tensors among ``xs`` and in its lists and tuples."""
    for a in xs:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from (t for t in a if isinstance(t, torch.Tensor))
