"""Mesh-level parallelism on torch.distributed (data + domain axes,
collectives)."""

from fss_tpu_torch.parallel import mesh, spawn

__all__ = ["mesh", "spawn"]
