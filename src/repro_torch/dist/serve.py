"""Serve-side distribution: one ServeEngine across a tensor-parallel
device group (the port of ``repro.dist.serve``).

Serving shards the *engine state*: model params by the ``tp`` policy's
rules, the KV page pools on their kv-heads dimension, page tables and
sampling state replicated.  In the paper's terms each TP shard is one more
memory channel behind the same request stream: the pools split across
devices as a buffer interleaved over banks, and the host-side
:class:`~repro_torch.serve.kvcache.PageAllocator` keeps one global page-id
space, so a table is valid on every shard as it is.

The reference is a single controller over a jax mesh, where GSPMD inserts
the collectives.  Here one process drives every shard: each shard's
tensors sit on the shard's own ``torch.device`` (devices may repeat: two
shards on one card, or on the CPU), the layer code runs every shard's ops
in turn (:mod:`repro_torch.models.transformer`), and the collectives are
written out as device-to-device copies, always reduced in shard order.
Those of a step (the inputs of column-parallel projections, the sums of
row-parallel partials, the vocab-split embedding and logits, the int8
KV amax, the MoE dispatch and combine, the recurrent mixers' copies) are
in :mod:`repro_torch.dist.tp`, which counts their bytes; the recurrent
state stays replicated in the cache, as in the reference's layout, and
every shard writes it whole after a step.  Here:

- :func:`broadcast`, a tree copied to every shard (the replicated params,
  tables and positions);
- :func:`gather`, the concatenation of head stripes (a swapped page
  assembled on the host);
- :func:`reduce_sum`, a sum in shard order (the DP replicas' gradients,
  :mod:`repro_torch.dist.dp_shardmap`).

The order is fixed, so a drain is deterministic, and it is the same code
on the CPU and on the card.  Determinism contract: shards partition the
head, ff, expert and recurrence-width dimensions, logits are gathered
once a step before token
selection, and the per-slot key chains never see the mesh, so a TP=N
drain gives the single-device engine's tokens wherever the two partial
sums round as the one product does (float32 on the CPU; PERF.md reports
the card's bfloat16 agreement).

DP is outside this class: independent engine replicas (each possibly TP)
behind one admission queue, :class:`~repro_torch.launch.serve.
ReplicaPool`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from repro_torch.dist.sharding import POLICIES, ShardingPolicy, spec_for
from repro_torch.launch.mesh import Mesh, visible_devices

# pool leaves split on their kv-heads dim; everything else in the paged
# cache (scale lanes, recurrent state, position rows) replicates
_POOL_LEAVES = ("k_pages", "v_pages")
# the dense cache of a draft model under TP splits its k/v rows the same way
_DENSE_LEAVES = ("k", "v")


# ---------------------------------------------------------------------------
# collectives over per-shard tensors (shard order, one process)
# ---------------------------------------------------------------------------

def broadcast(x, devices: Sequence[torch.device]) -> list:
    """One copy of ``x`` (a tensor or a nested dict of them) per shard, on
    the shard's device; a shard on ``x``'s own device shares it."""
    def put(t, dev):
        if isinstance(t, dict):
            return {k: put(v, dev) for k, v in t.items()}
        return t.to(dev)
    return [put(x, d) for d in devices]


def reduce_sum(parts: Sequence[torch.Tensor],
               device: torch.device) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` on ``device``, added in shard order."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


def gather(parts: Sequence[torch.Tensor], dim: int,
           device: torch.device) -> torch.Tensor:
    """The shards' slices concatenated on ``dim`` in shard order, on
    ``device``."""
    return torch.cat([p.to(device) for p in parts], dim=dim)


def split(x: torch.Tensor, dim: int, devices: Sequence[torch.device]) -> list:
    """``x`` cut into ``len(devices)`` contiguous equal blocks along
    ``dim``, block s on ``devices[s]`` (contiguous in memory); one
    device takes ``x`` itself."""
    if len(devices) == 1:
        return [x.to(devices[0])]
    return [c.to(d).contiguous()
            for c, d in zip(torch.chunk(x, len(devices), dim=dim), devices)]


def shard_dim(spec, axis: str) -> Optional[int]:
    """The dimension a spec splits over mesh axis ``axis`` (None:
    replicated along it)."""
    for i, entry in enumerate(spec):
        if entry == axis or (isinstance(entry, tuple) and axis in entry):
            return i
    return None


def as_indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the card it means (``cuda:<current>``), so that devices
    compare equal to the ones tensors report."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _leaf_name(path) -> str:
    return str(path[-1]) if path else ""


def _map_path(fn, tree, path=()):
    return {k: (_map_path(fn, v, path + (k,)) if isinstance(v, dict)
                else fn(path + (k,), v)) for k, v in tree.items()}


def check_tp(cfg, tp: int) -> None:
    """Shards need contiguous head blocks: tp must divide both head counts
    (the GQA group stays shard-invariant), the reference's one check.
    Past it every decoder serves at TP > 1: a MoE layer over the shards'
    experts, a recurrent mixer over their slices of its width or heads
    (:mod:`repro_torch.dist.tp`); an encoder-decoder or frontend stack is
    refused by the engine, which needs the paged backend under a mesh."""
    for name, val in (("num_heads", cfg.num_heads),
                      ("num_kv_heads", cfg.num_kv_heads)):
        if val % tp:
            raise ValueError(
                f"{cfg.name}: {name}={val} not divisible by tp={tp} — "
                "the paged shard_map islands partition heads in "
                "contiguous blocks (pad heads or lower tp)")


def _split_tree(tree, specs, axis: str, devices) -> list:
    """One tree per shard: each leaf cut in contiguous blocks along the
    dim its spec maps to ``axis`` (:func:`split`), or copied whole to
    every shard's device (:func:`broadcast`)."""
    def walk(t, spec):
        return {k: (walk(v, spec[k]) if isinstance(v, dict)
                    else broadcast(v, devices)
                    if shard_dim(spec[k], axis) is None
                    else split(v, shard_dim(spec[k], axis), devices))
                for k, v in t.items()}

    def pick(t, s):
        return {k: (pick(v, s) if isinstance(v, dict) else v[s])
                for k, v in t.items()}

    cuts = walk(tree, specs)
    return [pick(cuts, s) for s in range(len(devices))]


# ---------------------------------------------------------------------------
# the mesh + policy bundle the engine threads through its state
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ServeMesh:
    """A TP device group and the policy its params shard by.

    ``mesh`` carries the devices, ``axis`` the mesh axis heads and pools
    split over, ``policy`` the param rules (default: the ``tp`` policy, so
    serve and train agree on layouts).  The first device (``home``) holds
    the replicated state the engine keeps: positions, tokens, keys, the
    norms' inputs and the gathered logits."""

    mesh: Mesh
    axis: str = "model"
    policy: ShardingPolicy = dataclasses.field(
        default_factory=lambda: POLICIES["tp"])

    @classmethod
    def tp(cls, tp: Optional[int] = None, devices: Optional[Sequence] = None,
           axis: str = "model") -> "ServeMesh":
        """A 1-D TP mesh over the first ``tp`` of ``devices`` (default: the
        visible cards; a caller's explicit list may repeat a device)."""
        devs: List = [as_indexed(torch.device(d)) for d in (
            visible_devices() if devices is None else devices)]
        width = int(tp if tp is not None else len(devs))
        if not 1 <= width <= len(devs):
            raise ValueError(
                f"tp={width} needs {width} devices, have {len(devs)}")
        return cls(mesh=Mesh((axis,), (width,), tuple(devs[:width])),
                   axis=axis)

    @property
    def tp_degree(self) -> int:
        return int(self.mesh.shape[self.axis])

    @property
    def devices(self) -> List[torch.device]:
        """The shards' devices, in shard order."""
        return self.mesh.devices_along(self.axis)

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    # ------------------------------------------------------------------
    def validate(self, cfg) -> None:
        """Raise unless this mesh can serve ``cfg`` (:func:`check_tp`)."""
        check_tp(cfg, self.tp_degree)

    def bind(self, bundle):
        """The bundle rebound to this mesh: ``RuntimeFlags.mesh`` and
        ``tp_axis`` turn the model's entry points into per-shard loops
        (tp > 1), and the bundle's device is the mesh's home."""
        flags = dataclasses.replace(bundle.flags, mesh=self.mesh,
                                    tp_axis=self.axis)
        return dataclasses.replace(bundle, flags=flags, device=self.home)

    # ------------------------------------------------------------------
    def param_shardings(self, bundle, params):
        """Per-leaf specs of ``params`` under the policy."""
        return self.policy.param_shardings(self.mesh, params,
                                           bundle.param_specs())

    def shard_params(self, bundle, params):
        """The params as the shards hold them: each leaf sliced in
        contiguous blocks along the dimension the policy maps to the TP
        axis (replicated where it maps none), one tree per shard, each on
        its device.  TP=1 gives the tree itself on the home device."""
        shards = _split_tree(params, self.param_shardings(bundle, params),
                             self.axis, self.devices)
        return shards[0] if self.tp_degree == 1 else shards

    def replicated(self, x):
        """``x`` (a tensor or a dict tree) copied to every shard's device:
        a list of copies (TP=1: ``x`` on the home device)."""
        out = broadcast(x, self.devices)
        return out[0] if self.tp_degree == 1 else out

    # ------------------------------------------------------------------
    def _cache_specs(self, cache, names):
        def one(path, leaf):
            spec = [None] * leaf.dim()
            if _leaf_name(path) in names and leaf.dim() >= 4:
                spec[leaf.dim() - 2] = self.axis
            return tuple(spec)
        return _map_path(one, cache)

    def paged_cache_shardings(self, cache):
        """Per-leaf specs of a paged cache: k/v pools split on their
        kv-heads dim (dim ndim-2 of (..., pages, page_size, Hkv, D),
        stacked or not), everything else replicated."""
        return self._cache_specs(cache, _POOL_LEAVES)

    def _shard_cache(self, cache, specs):
        shards = _split_tree(cache, specs, self.axis, self.devices)
        return shards[0] if self.tp_degree == 1 else shards

    def shard_paged_cache(self, cache):
        """A paged cache allocated whole, as the shards hold it: one tree
        per shard with its kv-head stripe of every pool (the same page ids
        on every shard) and its copy of the replicated leaves."""
        return self._shard_cache(cache, self.paged_cache_shardings(cache))

    def shard_dense_cache(self, cache):
        """A dense cache (a draft model's under TP) as the shards hold it:
        k/v rows split on their kv-heads dim, scale and position lanes
        replicated."""
        return self._shard_cache(cache,
                                 self._cache_specs(cache, _DENSE_LEAVES))

    def page_swap_shardings(self, cache):
        """Specs governing the host-tier page swap on this mesh.

        Swap-out gathers whole pages along the *page* axis while the pools
        split on *kv-heads*, so each shard moves only its own stripe and
        the engine assembles full pages on the host (:func:`gather` on the
        split dim).  Swap-in is the transpose: the host pages are cut into
        stripes (:func:`split`) and each shard scatters its own.  The
        entry is the single-device one, so a page crosses between meshes
        of any widths (the disaggregated hand-off)."""
        return self.paged_cache_shardings(cache)
