"""Batch scheduling engine on a CUDA device (PyTorch port).

  - host-side encoder (tables.py): api objects -> Struct-of-Arrays cluster
    state (label/port/disk-key interning into bitsets, integer resource
    vectors, initial per-node aggregates),
  - device engine (engine.py): a sequential per-pod loop whose carry
    stays on the device; each step is O(nodes) work — predicate masks,
    integer 0..10 priority scores, masked argmax host selection with a
    deterministic tie-break — then an O(1) commit,
  - the scan kernel and the probe kernel (scan_kernel.py,
    csrc/scan_kernel.cu): a chunk of that loop in one launch, and the
    stateless [P, N] mask and score behind the extender Prioritize verb
    and mixed mode,
  - the predicate-filter kernel (filter_kernel.py, csrc/filter_kernel.cu)
    behind the extender Filter verb,
  - the dirty-row scatter kernel (scatter_kernel.py,
    csrc/scatter_kernel.cu) that keeps the engine's device table mirror
    current, and the preemption victim-search kernel (victim_kernel.py,
    csrc/victim_kernel.cu) behind BatchEngine.find_victims,
  - the node-axis mesh (mesh.py): NodeMesh splits the node axis into
    blocks, one a shard; the sharded scan and victim search exchange
    their per-pod records across the shards (K7) inside the kernels,
  - shard-failure tolerance (shardfail.py): shard leases, their monitor
    and the survivor re-shard.

Bit-exactness contract: given the same snapshot, the engine's assignments
equal the JAX engine's (and so the serial oracle's) pod for pod.
"""

from .tables import ClusterSnapshot, DevicePolicy, EncodeResult, encode_snapshot
from .engine import BatchEngine, schedule_batch
from .mesh import NodeMesh

__all__ = [
    "ClusterSnapshot", "DevicePolicy", "EncodeResult", "encode_snapshot",
    "BatchEngine", "schedule_batch", "NodeMesh",
]
