"""The whole served path's share of the card's peak: the sum over frames
served of the render's least time (``benchmark/counts.py``, at the
flight's views a launch), over the window times the cards. It bounds
every kernel's roofline share from above in what it can show end to end."""

from benchmark import readers


def read(data):
  if not data.get("flights") or not data.get("window_s"):
    return None
  least = readers.render_least_s(data, per_frame=True)
  if least <= 0:
    return None
  return 100.0 * least / (data["window_s"] * data["chips"])
