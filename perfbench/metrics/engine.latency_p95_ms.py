"""95th percentile of submit-to-retire latency over every request retired
inside the traced run's window, timed by the harness: the tail where the
device idles and the throughput is the end-to-end metric."""
from perfbench.bench import reduce


def read(r):
    lat = reduce.latencies_ms(r.records)
    return reduce.percentile(lat, 95) if len(lat) else None
