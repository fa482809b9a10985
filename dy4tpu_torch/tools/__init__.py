"""Command-line tools of the port: ``python -m dy4tpu_torch.tools.wideband``
(channelize a wideband capture and decode every station)."""
