"""Cloud provider interface and its call-recording fake.

Reference: pkg/cloudprovider/cloud.go (Interface: Instances,
LoadBalancers (TCPLoadBalancer at v1.1), Zones, Routes). The service and
route controllers (controllers/service.py) program against the
interface, and the fake is what they are tested with, as the
reference's own controllers are. The port carries no vendor provider.
"""

from .cloud import (CloudProvider, FakeCloudProvider, Instances,
                    LoadBalancer, LoadBalancers, Route, Routes, Zone,
                    Zones)

__all__ = ["CloudProvider", "FakeCloudProvider", "Instances",
           "LoadBalancer", "LoadBalancers", "Route", "Routes", "Zone",
           "Zones"]
