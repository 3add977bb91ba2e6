"""``device_idle_pct`` of the library cell (its pageable copies count as
busy), moving ``frame_ms.library``."""

from benchmark.harness import metric_reader

read = metric_reader("layer_metrics", "device_idle_pct")
