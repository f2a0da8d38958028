from .clock import Clock, FakeClock, RealClock
from .metrics import MetricsRegistry, global_metrics
from .trace import Trace
