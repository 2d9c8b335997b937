"""``readback_hidden_ms.burst``: the engine's ``readback_hidden`` phase a
served frame, and nothing where the program reports no such phase (a
program without row bands) or hid nothing (the CPU)."""

import pytest

from benchmark import run


def _data(requests, **phase_s):
  return {"service": {"requests": requests, "phase_s": phase_s}}


def test_reads_hidden_device_ms_a_request():
  got = run.read_metric("readback_hidden_ms.burst", _data(
      400, h2d=0.01, compute=0.5, readback=0.6, readback_hidden=0.12))
  assert got == pytest.approx(0.3)


@pytest.mark.parametrize("data", [
    {},                                                   # no counters
    _data(0, readback=0.1, readback_hidden=0.05),         # nothing served
    _data(10, h2d=0.0, compute=0.2, readback=0.1),        # no such phase
    _data(10, compute=0.2, readback=0.1, readback_hidden=0.0),  # hid nothing
])
def test_reads_nothing_where_there_is_nothing(data):
  assert run.read_metric("readback_hidden_ms.burst", data) is None
