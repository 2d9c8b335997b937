"""Per cent of the traced window with no operation on the card."""

from benchmark import readers


def read(data):
  return readers.idle_share(data)
