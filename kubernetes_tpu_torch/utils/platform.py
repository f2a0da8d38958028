"""The device a standalone entry point runs on.

The JAX package's module of this name pins a JAX platform and probes
the default one in a subprocess, falling back to the CPU when it does
not answer. The port picks a torch device instead and never falls back:
`--cpu` names the CPU; otherwise the entry point takes the CUDA device,
and raises when there is none (sched/device/engine.resolve_device)."""

from __future__ import annotations

import torch


def pick_device(cpu: bool = False) -> torch.device:
    """`cpu=True` (an entry point's `--cpu`): the CPU. Otherwise the
    CUDA device; no card is an error, never a quiet CPU run."""
    from ..sched.device.engine import resolve_device
    return resolve_device("cpu" if cpu else None)
