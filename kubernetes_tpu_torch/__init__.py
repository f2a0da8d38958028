"""PyTorch / CUDA port of kubernetes_tpu's device scheduling path.

A package of its own beside `kubernetes_tpu` (the JAX reference, which
stays as it is). It imports torch and numpy, never jax and nothing of
`kubernetes_tpu`: the host modules it needs (core types and wire format,
the scheduler's predicates / priorities / policy API, the snapshot
encoder) are its own copies. Entry points run on the CUDA device unless
the caller passes another device explicitly.
"""
