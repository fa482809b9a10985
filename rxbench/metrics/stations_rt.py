"""Stations held in real time: station-seconds of broadcast whose
outputs landed in the window, over the window's seconds (from the first
chunk handed over to the last one landed)."""


def read(run):
    done = run.counted()
    b = run.bench
    seconds = done[-1].t_land - run.window.t_start
    return b.c * b.block_s * b.k * len(done) / seconds
