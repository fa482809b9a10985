"""``roofline_pct.audio_backend`` of the small-site cells, read as the fleet's
is, under a name of its own because it moves the small site's end-to-end
metric."""

from rxbench import spec

read = spec.metric_reader("roofline_pct.audio_backend").read
