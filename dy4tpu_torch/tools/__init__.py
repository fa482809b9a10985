"""Command-line tools of the port: ``python -m dy4tpu_torch.tools.synth``
(fabricate a capture), ``.ratechange`` (convert its rate), ``.psdview``
(per-block PSDs through kernel B10) and ``.wideband`` (channelize a
wideband capture and decode every station)."""
