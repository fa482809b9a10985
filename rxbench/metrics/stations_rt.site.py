"""``stations_rt`` of the small-site cells, read as the fleet's is, under a
name of its own: the small site's pace swings more from run to run, so it is
held to a bound of its own (``BENCHMARK.json``)."""

from rxbench import spec

read = spec.metric_reader("stations_rt").read
