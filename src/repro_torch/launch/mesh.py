"""Device meshes: named axis sizes over a row-major list of devices.

The port of ``repro.launch.mesh``.  A :class:`Mesh` is plain bookkeeping
(no process group, no collective library): the serving layer
(:mod:`repro_torch.dist.serve`) and the sharded steps
(:mod:`repro_torch.dist.steps`) drive every shard from one process, and
the shards' tensors sit on the mesh's own ``torch.device``s.  Devices may
repeat, so two shards can share one card or the CPU, and a mesh of
``meta`` devices is what the dry-run accounts a step on
(:func:`make_production_mesh`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    """``axis_names`` with their ``sizes`` over ``devices`` in row-major
    order (the last axis varies fastest)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.sizes)} sizes")
        if math.prod(self.sizes) != len(self.devices):
            raise ValueError(f"a {self.sizes} mesh needs "
                             f"{math.prod(self.sizes)} devices, got "
                             f"{len(self.devices)}")

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, as the reference's ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    def devices_along(self, axis: str) -> List[torch.device]:
        """The devices of the first line of the mesh along ``axis`` (every
        other axis at index 0), in axis order."""
        k = self.axis_names.index(axis)
        stride = math.prod(self.sizes[k + 1:])
        return [self.devices[i * stride] for i in range(self.sizes[k])]


def visible_devices() -> List[torch.device]:
    """Every CUDA card this process sees, each once (none without a
    card)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_production_mesh(devices: Sequence, *, multi_pod: bool = False
                         ) -> Mesh:
    """The reference's production shapes over a device list the caller
    gives: (16, 16) over ``("data", "model")``, or (2, 16, 16) with a
    leading ``"pod"`` axis (pure data parallelism across pods).  The
    dry-run passes ``"meta"`` repeated; a caller with cards passes them
    (repeated, to lay 256 shards on fewer cards)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    devs = [torch.device(d) for d in devices]
    if len(devs) < n:
        raise ValueError(f"a {shape} mesh needs {n} devices, have "
                         f"{len(devs)}")
    return Mesh(axes, shape, tuple(devs[:n]))


def make_test_mesh(data: int = 4, model: int = 2,
                   devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh at test scale over ``devices`` (default: the
    visible cards, which must number at least data x model); a caller's
    list may repeat a device (``["cpu"] * 8`` on a host with no card)."""
    devs = [torch.device(d) for d in (visible_devices() if devices is None
                                      else devices)]
    if data * model > len(devs):
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"devices, have {len(devs)}")
    return Mesh(("data", "model"), (data, model),
                tuple(devs[:data * model]))
