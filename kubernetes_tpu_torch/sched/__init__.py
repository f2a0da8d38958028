from .api import HostPriority, Policy
from .generic import FitError, GenericScheduler, NoNodesAvailable
