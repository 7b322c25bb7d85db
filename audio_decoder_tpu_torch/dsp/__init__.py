from .consensus import consensus_config, consensus_for
from .resample import resample_batch, resample_to_consensus
from .route import route_channels, routing_matrix

__all__ = [
    "consensus_config", "consensus_for", "resample_batch",
    "resample_to_consensus", "route_channels", "routing_matrix",
]
