"""decode_p95_ms: the 95th percentile (nearest rank) of the host-clock
latency of every decode request the window completed, in ms.  With 20
requests or fewer it is their maximum."""

import math


def read(run):
    lat = sorted(run.latencies_of("decode"))
    if not lat:
        return None
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
