"""The traced launches of the kernels ``rooflines/audio_backend.py`` names:
their roofline bound as a percentage of their mean device time."""


def read(run):
    return run.roofline_pct("audio_backend")
