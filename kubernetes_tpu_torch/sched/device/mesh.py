"""The engine's node-axis mesh: the counterpart of the JAX engine's
one-axis `jax.sharding.Mesh` and of its `_node_shardings`
(`kubernetes_tpu/sched/device/engine.py`).

    mesh = NodeMesh(["cuda:0"] * 4)        # four shards on one card
    engine = BatchEngine(mesh=mesh)
    NodeMesh(["cpu"] * 4)                  # the plain versions, on the CPU

The node axis of N slots (N a multiple of the mesh size: the encoders
round it, `node_pad_to=` / `mesh_devices=`) is split into `size`
contiguous blocks, shard k owning slots [k * B, (k + 1) * B), B =
N // size. What is split and what every shard holds whole is written
once here (`NODE_SPLIT`, `STATE_SPLIT`, `STATE_REPLICATED`): the plain
sharded scan (`scan_kernel.scan_chunk_sharded_plain`) takes its block
views through `block_view`, and the sharded kernels (`scan_kernel.
scan_chunk_sharded`, `victim_kernel.victim_search_sharded`) index the
same blocks.

One process drives every shard, as JAX's single-process mesh does.
Devices may repeat: shards on one card are clusters of one launch,
exchanging their per-pod records (K7) through global memory. The engine
runs only a mesh whose shards share one device: placing the tables and
launching a device's shards on each of several cards is not written
(ROADMAP.md), and BatchEngine refuses such a mesh.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

# the axis of each NodeConst field that the mesh splits (the others,
# offgrid_max and zone_scratch, every shard holds whole)
NODE_SPLIT: Dict[str, int] = {
    "valid": 0, "sched_ok": 0, "cpu_cap": 0, "mem_cap": 0, "pod_cap": 0,
    "labels": 0, "tie_rank": 0, "exceed_cpu": 0, "exceed_mem": 0,
    "aff_dom": 1, "zone_id": 0, "static_mask": 0, "static_score": 0}
NODE_REPLICATED = ("offgrid_max", "zone_scratch")
# State: the per-slot rows and the per-slot columns of the group counts
# are split; the counts every shard reads whole are replicated, and
# every shard commits the same update into its own copy
STATE_SPLIT: Dict[str, int] = {
    "cpu_used": 0, "mem_used": 0, "nz_cpu": 0, "nz_mem": 0,
    "pod_count": 0, "port_bits": 0, "disk_any": 0, "disk_rw": 0,
    "spread": 1, "svc_count": 1}
STATE_REPLICATED = ("aff_count", "aff_total", "svc_total")
# PodXs is replicated whole; so are the victim search's preemptor
# scalars, while its node rows split like the State's


def _cut(t: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    return t[lo:hi] if axis == 0 else t[:, lo:hi]


class NodeMesh:
    """`devices` (names or torch.devices, repeats allowed), one shard
    each, in order. All CUDA or all CPU."""

    def __init__(self, devices: Sequence):
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("NodeMesh: no devices")
        kinds = {d.type for d in devs}
        if kinds not in ({"cuda"}, {"cpu"}):
            raise ValueError(f"NodeMesh: devices must be all CUDA or all "
                             f"CPU, not {sorted(kinds)}")
        if kinds == {"cuda"}:
            devs = [torch.device("cuda", d.index if d.index is not None
                                 else torch.cuda.current_device())
                    for d in devs]
        self.devices: Tuple[torch.device, ...] = tuple(devs)

    def __repr__(self) -> str:
        return f"NodeMesh({[str(d) for d in self.devices]})"

    def __eq__(self, other) -> bool:
        return isinstance(other, NodeMesh) and other.devices == self.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """Shard 0's device: where the engine keeps what the shards
        share when they share a card."""
        return self.devices[0]

    @property
    def one_device(self) -> bool:
        """Every shard on the same device (the CPU, or one card)."""
        return len(set(self.devices)) == 1

    def block(self, n: int) -> int:
        """Slots a shard owns over a node axis of n slots."""
        if n % self.size:
            raise ValueError(f"NodeMesh: {n} slots do not split over "
                             f"{self.size} shards; pad the node axis to "
                             f"a multiple of the mesh size")
        return n // self.size

    def blocks(self, n: int) -> Tuple[Tuple[int, int], ...]:
        """Each shard's slot range [lo, hi) over n slots."""
        b = self.block(n)
        return tuple((k * b, (k + 1) * b) for k in range(self.size))

    def owner(self, slot: int, n: int) -> int:
        """The shard that owns `slot` of n."""
        return slot // self.block(n)

    def survivors(self, dead: Sequence[int]) -> Optional["NodeMesh"]:
        """The mesh without the `dead` shards, the others in their order
        (shard s of the result is the s'th survivor); None when none
        survives."""
        gone = set(dead)
        devs = [d for i, d in enumerate(self.devices) if i not in gone]
        return NodeMesh(devs) if devs else None


def block_view(tree, split: Dict[str, int], lo: int, hi: int,
               whole: Optional[dict] = None):
    """A NamedTuple of tensors cut to one shard's slots [lo, hi): every
    field in `split` a view along its axis (writes land in `tree`), the
    others as they are or as `whole` gives them (a shard's own copy of a
    replicated field)."""
    whole = whole or {}
    return type(tree)(*(
        _cut(t, split[f], lo, hi) if f in split else whole.get(f, t)
        for f, t in zip(type(tree)._fields, tree)))
