"""% of the traced window, over every card, in which the card ran no
kernel, copy or memset."""

from benchmark.metrics.common import idle_share


def read(record):
    return idle_share(record)
