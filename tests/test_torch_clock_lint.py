"""Lint: the port's serve/ (cluster/, assets/, edge/ and session/
included), obs/, ckpt/, and the hardened train files read time only
through injectable clocks.

The counterpart of ``tests/serve/test_clock_lint.py`` for
``mpi_vision_tpu_torch``. Every latency, deadline, span edge, stall
measurement, lease stamp and manifest timestamp must come from a clock
the caller can inject — that is what makes the breaker, scheduler,
tracer, metrics, checkpoint store, router, supervisor, gossip, leases,
autoscaler and stall watchdog deterministic on fake clocks and keeps all
timestamps on ONE base in production. A bare ``time.time()`` /
``time.monotonic()`` / ``time.perf_counter()`` call creeping into a hot
path silently breaks both, so this test greps the source.

Designated defaults stay legal: ``clock=time.monotonic`` in a signature
or ``clock if clock else time.monotonic`` pass the *function object* —
only call sites (with parentheses) are flagged. ``time.sleep`` is a
different contract (injected separately where determinism needs it) and
is not a clock read.
"""

import pathlib
import re

import mpi_vision_tpu_torch.ckpt
import mpi_vision_tpu_torch.obs
import mpi_vision_tpu_torch.serve
import mpi_vision_tpu_torch.serve.assets
import mpi_vision_tpu_torch.serve.cluster
import mpi_vision_tpu_torch.serve.edge
import mpi_vision_tpu_torch.serve.session
import mpi_vision_tpu_torch.train.faultinject
import mpi_vision_tpu_torch.train.loop
import mpi_vision_tpu_torch.train.queue
import mpi_vision_tpu_torch.train.supervisor
import mpi_vision_tpu_torch.train.telemetry

_CLOCK_CALL = re.compile(r"\btime\.(time|monotonic|perf_counter)\s*\(")


def _package_sources(pkg):
  root = pathlib.Path(pkg.__file__).parent
  return sorted(root.glob("*.py"))


def _linted_sources():
  for pkg in (mpi_vision_tpu_torch.serve,
              mpi_vision_tpu_torch.serve.assets,
              mpi_vision_tpu_torch.serve.cluster,
              mpi_vision_tpu_torch.serve.edge,
              mpi_vision_tpu_torch.serve.session,
              mpi_vision_tpu_torch.obs, mpi_vision_tpu_torch.ckpt):
    yield from _package_sources(pkg)
  yield pathlib.Path(mpi_vision_tpu_torch.train.loop.__file__)
  yield pathlib.Path(mpi_vision_tpu_torch.train.telemetry.__file__)
  # The training queue tier: lease timestamps, retry backoff floors,
  # wedge/grace windows — all injected-clock territory.
  yield pathlib.Path(mpi_vision_tpu_torch.train.queue.__file__)
  yield pathlib.Path(mpi_vision_tpu_torch.train.supervisor.__file__)
  yield pathlib.Path(mpi_vision_tpu_torch.train.faultinject.__file__)


def test_no_bare_clock_calls_in_serve_obs_ckpt_train():
  offenders = []
  for path in _linted_sources():
    for lineno, line in enumerate(path.read_text().splitlines(), 1):
      code = line.split("#", 1)[0]
      if _CLOCK_CALL.search(code):
        offenders.append(f"{path.name}:{lineno}: {line.strip()}")
  assert not offenders, (
      "bare clock calls in serve/obs/ckpt/train-loop hot paths (inject a "
      "clock instead; attribute references like clock=time.monotonic are "
      "fine):\n" + "\n".join(offenders))


def test_lint_covers_the_ckpt_package_and_train_loop():
  # Package-qualified so e.g. serve/faultinject.py can never satisfy a
  # check meant for ckpt/faultinject.py. If these move, re-point the
  # lint — silently shrinking coverage is exactly the failure mode this
  # test exists to prevent.
  rel = {"/".join(p.parts[-2:]) for p in _linted_sources()}
  assert {"ckpt/store.py", "ckpt/guards.py", "ckpt/faultinject.py",
          "ckpt/watch.py", "ckpt/background.py", "serve/faultinject.py",
          "serve/engine.py", "serve/scheduler.py", "serve/metrics.py",
          # The tile tier: the planner is request-path code and
          # the tile/crop caches feed the latency accounting.
          "serve/tiles.py", "serve/cache.py", "serve/server.py",
          # The brownout tier: dwell and recovery windows are
          # the hysteresis — one bare clock call makes the ladder
          # untestable and ties descent cadence to wall time.
          "serve/brownout.py",
          "train/loop.py", "train/telemetry.py", "train/queue.py",
          "train/supervisor.py", "train/faultinject.py",
          "cluster/router.py",
          "cluster/ring.py", "cluster/pool.py", "cluster/supervisor.py",
          # The router-HA tier: gossip versions and lease
          # heartbeats ARE timestamps — one bare clock call desyncs
          # the anti-entropy merge from the takeover math.
          "cluster/gossip.py", "cluster/lease.py",
          # The elastic fleet: sustain windows, cooldowns, and
          # the scaling budget ARE the anti-flap guarantees — a bare
          # clock call would weld them to wall time.
          "cluster/autoscale.py",
          # The asset tier: sync sweep timing and watcher polls
          # ride the same injected clocks as the checkpoint watcher.
          "assets/store.py", "assets/fetch.py",
          "edge/cache.py", "edge/lattice.py", "edge/warp.py",
          # The session tier: idle reaping and frame deadlines
          # ride the manager's injectable clock — a bare call would
          # make reap tests flaky and weld idle timeouts to wall time.
          "session/manager.py", "session/protocol.py",
          "session/predictor.py",
          "obs/slo.py", "obs/events.py", "obs/trace.py",
          "obs/prom.py", "obs/hist.py", "obs/tsdb.py",
          "obs/ship.py",
          # The incident lens: the attribution ledger stamps
          # queue-wait and device seconds, and the recorder timestamps
          # bundles — bare clock calls would make conservation and
          # capture dedup untestable.
          "obs/attrib.py", "obs/incident.py"} <= rel


def test_lint_actually_catches_calls():
  # The regex must flag real call sites, not just pass everything.
  assert _CLOCK_CALL.search("t0 = time.monotonic()")
  assert _CLOCK_CALL.search("x = time.perf_counter ()")
  assert not _CLOCK_CALL.search("clock=time.monotonic")
  assert not _CLOCK_CALL.search("sleep = time.sleep")
