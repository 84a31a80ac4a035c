"""Online serving for trained pools (port of ``repro/serve``): a
`PoolServer` scores queries with a pool's ensemble, `TrafficSpec` /
`materialize_trace` turn request load into data, and `serve_trace`
measures latency, throughput and accuracy under that load."""
from repro_torch.serve.engine import (DEFAULT_BUCKETS, FactoredMembers,
                                      PoolServer)
from repro_torch.serve.metrics import ServeReport, serve_trace
from repro_torch.serve.traffic import (RequestTrace, TrafficSpec, get_traffic,
                                       list_traffics, materialize_trace,
                                       register_traffic)

__all__ = [
    "DEFAULT_BUCKETS", "FactoredMembers", "PoolServer",
    "ServeReport", "serve_trace",
    "RequestTrace", "TrafficSpec", "get_traffic", "list_traffics",
    "materialize_trace", "register_traffic",
]
