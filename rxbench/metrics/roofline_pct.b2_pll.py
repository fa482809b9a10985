"""The traced launches of the kernels ``rooflines/b2_pll.py`` names:
their roofline bound as a percentage of their mean device time."""


def read(run):
    return run.roofline_pct("b2_pll")
