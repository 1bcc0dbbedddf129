"""Share of the traced fine-tuning window in which nothing ran on the card."""
from benchmark.metrics import idle


def read(data):
    return idle.pct(data)
