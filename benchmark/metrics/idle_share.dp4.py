"""Per cent of the traced window with no operation on a card, averaged
over the four cards."""

from benchmark import readers


def read(data):
  return readers.idle_share(data)
