"""``frame_ms`` of the library cell's host-bound requests, held to a bound
of its own."""

from benchmark.harness import metric_reader

read = metric_reader("end_to_end", "frame_ms")
