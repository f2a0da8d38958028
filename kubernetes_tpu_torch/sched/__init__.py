from .api import HostPriority, Policy

__all__ = ["HostPriority", "Policy"]
