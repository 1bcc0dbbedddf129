"""Share of the traced generation window in which nothing ran on the card:
one minus the union of the device activities' intervals over the window."""
from benchmark.metrics import idle


def read(data):
    return idle.pct(data)
