from .histogram import LatencyHistogram
from .stats import StatsRecord
from .tracing import parse_sample_rate

__all__ = ["StatsRecord", "LatencyHistogram", "parse_sample_rate"]
