"""Idle share of the card over the traced KIFMM window, %."""
from portbench.metrics import idle_share


def read(data):
    return idle_share(data)
