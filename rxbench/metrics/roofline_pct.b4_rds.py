"""The traced launches of the kernels ``rooflines/b4_rds.py`` names:
their roofline bound as a percentage of their mean device time."""


def read(run):
    return run.roofline_pct("b4_rds")
