"""The traced launches of the kernels ``rooflines/b1_frontend.py`` names:
their roofline bound as a percentage of their mean device time."""


def read(run):
    return run.roofline_pct("b1_frontend")
