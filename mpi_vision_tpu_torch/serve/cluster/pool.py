"""Local backend supervision: spawn, health-gate, kill, resurrect.

A copy of ``mpi_vision_tpu/serve/cluster/pool.py`` whose children are
the PyTorch package's ``serve``: ``BackendPool`` runs N real ``python -m
mpi_vision_tpu_torch serve --device <device>`` child processes on
localhost ephemeral ports. Every child renders on the card by default
(``device="cuda"``): on a machine with no card a ``cuda`` pool fails to
start with ``BackendSpawnError`` carrying the child's log tail, and no
CPU backend takes its place; tests pass ``device="cpu"``. It owns the process
*primitives* only (spawn, health-gate, kill, respawn-on-same-port); the
self-healing *policy* — who gets restarted, when, and when to give up —
lives in ``supervisor.FleetSupervisor``, which drives these primitives
(production runs one backend per host under k8s/systemd; the router
neither knows nor cares who spawned its backends):

  * each backend writes its bound port to a ``--port-file`` (parsing a
    child's stderr for the listening line is a race, a file rename is
    not), and the pool gates on ``/healthz`` == ok before declaring it
    up;
  * ``kill()`` delivers a real signal (tests use SIGKILL: the backend
    gets no chance to drain, exactly like a host loss), ``restart()``
    respawns on the SAME port so the router's breaker sees the backend
    "come back" at its old address and re-closes through the half-open
    probe;
  * every backend serves the SAME synthetic scene set (ids and pixels
    are a pure function of ``(seed, scene_id)`` — ``synthetic_scene``),
    which is what makes replica failover return bit-identical pixels.

Time reads go through injectable ``clock``/``sleep`` (the serve/-wide
lint rule); child stdout/stderr land in per-backend log files under the
pool's workdir for post-mortems.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import urllib.request


class BackendSpawnError(RuntimeError):
  """A backend failed to come up healthy inside the startup budget."""


class _Proc:
  def __init__(self, backend_id: str, popen, port: int, log_path: str):
    self.backend_id = backend_id
    self.popen = popen
    self.port = port
    self.log_path = log_path


class BackendPool:
  """Spawn and supervise N local serve backends (tests/bench only).

  Args:
    n_backends: pool size.
    scenes / img_size / planes: synthetic scene set every backend
      serves (identical across the pool — replication needs replicas).
    host: bind address for the children.
    device: every child's ``serve --device`` (``"cuda"``: the card;
      ``"cpu"`` only when asked for).
    env: child environment (default: inherit).
    extra_args: appended to every child's ``serve`` argv (e.g.
      ``["--no-resilience"]`` or checkpoint flags).
    workdir: port files + logs (default: a self-cleaning temp dir).
    startup_timeout_s: per-backend budget to bind + pass /healthz.
    clock / sleep: injectable time sources.
    log: diagnostics sink (None = silent).
  """

  def __init__(self, n_backends: int, scenes: int = 4, img_size: int = 32,
               planes: int = 4, seed: int = 0, host: str = "127.0.0.1",
               device: str = "cuda", env: dict | None = None, extra_args=(),
               workdir: str | None = None, startup_timeout_s: float = 180.0,
               clock=time.monotonic, sleep=time.sleep, log=None):
    if n_backends < 1:
      raise ValueError(f"n_backends must be >= 1, got {n_backends}")
    self.n_backends = int(n_backends)
    self.scenes = int(scenes)
    self.img_size = int(img_size)
    self.planes = int(planes)
    self.seed = int(seed)
    self.host = host
    if device not in ("cuda", "cpu"):
      raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    self.device = device
    self.env = dict(os.environ if env is None else env)
    # Children run with cwd=workdir: put the package root on PYTHONPATH
    # so `-m mpi_vision_tpu_torch` resolves without an installed wheel.
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    self.env["PYTHONPATH"] = pkg_root + os.pathsep + self.env.get(
        "PYTHONPATH", "")
    self.extra_args = list(extra_args)
    self._own_workdir = workdir is None
    self.workdir = workdir or tempfile.mkdtemp(prefix="mpi_cluster_")
    self.startup_timeout_s = float(startup_timeout_s)
    self._clock = clock
    self._sleep = sleep
    self._log = log if log is not None else (lambda msg: None)
    self._procs: dict[str, _Proc] = {}
    self._closed = False

  # -- lifecycle ----------------------------------------------------------

  def scene_ids(self) -> list[str]:
    """The scene ids every backend serves (server.add_synthetic_scenes)."""
    return [f"scene_{i:03d}" for i in range(self.scenes)]

  def addresses(self) -> dict[str, str]:
    """``backend_id -> host:port`` for Router construction."""
    return {bid: f"{self.host}:{p.port}"
            for bid, p in sorted(self._procs.items())}

  def start(self) -> dict[str, str]:
    """Spawn every backend and wait until each passes ``/healthz``.

    Children spawn concurrently (the torch import and the kernel build
    dominate startup; N sequential starts would multiply it) and then
    health-gate in
    order. Returns ``addresses()``.
    """
    pending = []
    for i in range(self.n_backends):
      backend_id, popen, port_file, log_path = self._spawn(f"b{i}")
      # Register BEFORE gating: if any gate below fails, close() must be
      # able to terminate every child already spawned, not orphan them.
      self._procs[backend_id] = _Proc(backend_id, popen, 0, log_path)
      pending.append((backend_id, popen, port_file))
    for backend_id, popen, port_file in pending:
      port = self._await_port(backend_id, popen, port_file)
      proc = self._procs[backend_id]
      proc.port = port
      self._await_healthy(proc)
      self._log(f"pool: {backend_id} healthy on {self.host}:{port}")
    return self.addresses()

  def _spawn(self, backend_id: str, port: int = 0):
    port_file = os.path.join(self.workdir, f"{backend_id}.port")
    if os.path.exists(port_file):
      os.unlink(port_file)
    log_path = os.path.join(self.workdir, f"{backend_id}.log")
    argv = [
        sys.executable, "-m", "mpi_vision_tpu_torch", "serve",
        "--device", self.device,
        "--host", self.host, "--port", str(port),
        "--port-file", port_file,
        "--scenes", str(self.scenes),
        "--img-size", str(self.img_size),
        "--num-planes", str(self.planes),
        *self.extra_args,
    ]
    log_fh = open(log_path, "ab")
    try:
      popen = subprocess.Popen(argv, stdout=log_fh, stderr=log_fh,
                               env=self.env, cwd=self.workdir)
    finally:
      log_fh.close()  # the child holds its own fd now
    return backend_id, popen, port_file, log_path

  def _await_port(self, backend_id: str, popen, port_file: str) -> int:
    deadline = self._clock() + self.startup_timeout_s
    while self._clock() < deadline:
      if popen.poll() is not None:
        raise BackendSpawnError(
            f"{backend_id} exited rc={popen.returncode} before binding "
            f"(log: {self.tail_log(backend_id)})")
      if os.path.exists(port_file):
        try:
          with open(port_file) as fh:
            return int(fh.read().strip())
        except (OSError, ValueError):
          pass  # written-but-not-renamed race; go around
      self._sleep(0.05)
    raise BackendSpawnError(
        f"{backend_id} did not bind within {self.startup_timeout_s:.0f}s")

  def _await_healthy(self, proc: _Proc) -> None:
    deadline = self._clock() + self.startup_timeout_s
    url = f"http://{self.host}:{proc.port}/healthz"
    while self._clock() < deadline:
      if proc.popen.poll() is not None:
        raise BackendSpawnError(
            f"{proc.backend_id} exited rc={proc.popen.returncode} before "
            f"healthy (log: {self.tail_log(proc.backend_id)})")
      try:
        with urllib.request.urlopen(url, timeout=2.0) as resp:
          if json.loads(resp.read()).get("status") == "ok":
            return
      except (OSError, ValueError):
        pass
      self._sleep(0.1)
    raise BackendSpawnError(
        f"{proc.backend_id} not healthy within {self.startup_timeout_s:.0f}s "
        f"(log: {self.tail_log(proc.backend_id)})")

  # -- chaos --------------------------------------------------------------

  def kill(self, backend_id: str, sig: int = signal.SIGKILL) -> None:
    """Deliver ``sig`` (default SIGKILL: a host loss, no drain;
    SIGTERM: the serve CLI drains in-flight requests first) and wait
    for the process to die. Idempotent on an already-dead backend — a
    crash-loop drill's killer thread may race the supervisor's respawn,
    and double-killing a corpse must be a no-op, not an error."""
    proc = self._procs[backend_id]
    if proc.popen.poll() is not None:
      return  # already dead
    proc.popen.send_signal(sig)
    proc.popen.wait(30)
    self._log(f"pool: {backend_id} killed with signal {sig}")

  def alive(self, backend_id: str) -> bool:
    proc = self._procs.get(backend_id)
    return proc is not None and proc.popen.poll() is None

  def pid(self, backend_id: str) -> int | None:
    """The backend's current OS pid (None for unknown ids) — how a test
    proves a rolling restart really replaced every process."""
    proc = self._procs.get(backend_id)
    return proc.popen.pid if proc is not None else None

  def restart(self, backend_id: str) -> str:
    """Respawn a dead backend on its OLD port (same address, so the
    router's existing breaker re-closes via its half-open probe rather
    than needing re-registration). Returns the address.

    Refuses on a closed pool — a supervisor tick blocked inside a slow
    respawn can outlive ``FleetSupervisor.stop()``'s join timeout, and
    without this guard it would register a fresh child into a pool
    ``close()`` already swept, orphaning a serve process past exit.
    """
    if self._closed:
      raise RuntimeError(f"pool is closed; not restarting {backend_id}")
    old = self._procs[backend_id]
    if old.popen.poll() is None:
      raise RuntimeError(f"{backend_id} is still running; kill it first")
    _, popen, port_file, log_path = self._spawn(backend_id, port=old.port)
    # Register BEFORE gating (like start()): close() must always see the
    # child. If close() raced the spawn itself, reap the child here —
    # close()'s sweep may have run before the registration landed.
    proc = _Proc(backend_id, popen, old.port, log_path)
    self._procs[backend_id] = proc
    if self._closed:
      popen.terminate()
      try:
        popen.wait(10)
      except subprocess.TimeoutExpired:
        popen.kill()
        popen.wait(10)
      raise RuntimeError(f"pool closed during restart of {backend_id}")
    proc.port = self._await_port(backend_id, popen, port_file)
    self._await_healthy(proc)
    self._log(f"pool: {backend_id} resurrected on {self.host}:{proc.port}")
    return f"{self.host}:{proc.port}"

  # -- elastic sizing (the autoscaler's primitives) -----------------------

  def spawn_backend(self, backend_id: str | None = None) -> tuple[str, str]:
    """Grow the pool by ONE backend on a fresh ephemeral port and gate
    it healthy (the autoscaler's scale-up primitive; ``start()`` sizes
    only the initial pool). Returns ``(backend_id, address)``.

    Registers before gating, like ``start()``/``restart()``, so
    ``close()`` can always sweep the child. A failed gate reaps the
    corpse and unregisters it — a failed grow leaves the pool exactly
    as it was (the caller's scale-up aborts, nothing is stranded).
    """
    if self._closed:
      raise RuntimeError("pool is closed; not spawning a new backend")
    if backend_id is None:
      i = 0
      while f"b{i}" in self._procs:
        i += 1
      backend_id = f"b{i}"
    existing = self._procs.get(backend_id)
    if existing is not None and existing.popen.poll() is None:
      raise ValueError(f"{backend_id} is already running")
    backend_id, popen, port_file, log_path = self._spawn(backend_id)
    proc = _Proc(backend_id, popen, 0, log_path)
    self._procs[backend_id] = proc
    if self._closed:  # close() raced the spawn (restart()'s idiom)
      popen.terminate()
      try:
        popen.wait(10)
      except subprocess.TimeoutExpired:
        popen.kill()
        popen.wait(10)
      self._procs.pop(backend_id, None)
      raise RuntimeError(f"pool closed during spawn of {backend_id}")
    try:
      proc.port = self._await_port(backend_id, popen, port_file)
      self._await_healthy(proc)
    except BackendSpawnError:
      if popen.poll() is None:
        popen.kill()
        try:
          popen.wait(10)
        except subprocess.TimeoutExpired:
          pass
      self._procs.pop(backend_id, None)
      raise
    self._log(f"pool: {backend_id} grown onto {self.host}:{proc.port}")
    return backend_id, f"{self.host}:{proc.port}"

  def retire(self, backend_id: str) -> None:
    """Remove a backend from the pool for good (scale-down): SIGTERM if
    still alive (the serve CLI drains in-flight requests), wait, and
    forget the record. Idempotent — retiring an unknown or already-dead
    backend is a no-op, never an error."""
    proc = self._procs.pop(str(backend_id), None)
    if proc is None:
      return
    if proc.popen.poll() is None:
      proc.popen.terminate()
      try:
        proc.popen.wait(30)
      except subprocess.TimeoutExpired:
        proc.popen.kill()
        proc.popen.wait(10)
    self._log(f"pool: {backend_id} retired")

  # -- teardown / forensics ----------------------------------------------

  def tail_log(self, backend_id: str, n: int = 2000) -> str:
    path = (self._procs[backend_id].log_path
            if backend_id in self._procs else
            os.path.join(self.workdir, f"{backend_id}.log"))
    try:
      with open(path, "rb") as fh:
        fh.seek(0, os.SEEK_END)
        size = fh.tell()
        fh.seek(max(size - n, 0))
        return fh.read().decode("utf-8", "replace")
    except OSError:
      return "<no log>"

  def close(self) -> None:
    if self._closed:
      return
    self._closed = True
    for proc in self._procs.values():
      if proc.popen.poll() is None:
        proc.popen.terminate()
    deadline = self._clock() + 10.0
    for proc in self._procs.values():
      timeout = max(deadline - self._clock(), 0.1)
      try:
        proc.popen.wait(timeout)
      except subprocess.TimeoutExpired:
        proc.popen.kill()
        proc.popen.wait(10)
    if self._own_workdir:
      shutil.rmtree(self.workdir, ignore_errors=True)

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


class RemoteBackendPool:
  """Pool facade over backends some OTHER system owns (``--join``).

  A joined fleet has no local process handles, so supervision degrades
  gracefully to the k8s-operator shape: liveness is the PROBER's
  judgment (``alive()`` always answers True — a remote corpse shows up
  as ``unreachable`` probes, walks the same wedge counter, and is
  declared DOWN with identical eject/quarantine/readmit semantics), and
  ``restart()`` either invokes an operator-supplied webhook
  (``restart_hook``: a shlex-split argv run with the backend id and
  address appended — the analogue of poking a k8s Deployment) or is a
  no-op that leaves recovery to whatever owns the process, with the
  next probe pass deciding the truth either way. Hook failures raise —
  the supervisor counts them as restart failures and keeps looping;
  they are never fatal.
  """

  def __init__(self, backends: dict, restart_hook: str | None = None,
               hook_timeout_s: float = 30.0, runner=None, log=None):
    if not backends:
      raise ValueError("RemoteBackendPool needs at least one backend")
    if hook_timeout_s <= 0:
      raise ValueError(
          f"hook_timeout_s must be > 0, got {hook_timeout_s}")
    self._backends = {str(b): str(a) for b, a in backends.items()}
    self.restart_hook = restart_hook
    self._hook_argv = (None if restart_hook is None
                       else _shlex_split(restart_hook))
    if self._hook_argv is not None and not self._hook_argv:
      raise ValueError("restart_hook must not be empty")
    self.hook_timeout_s = float(hook_timeout_s)
    self._runner = runner if runner is not None else subprocess.run
    self._log = log if log is not None else (lambda msg: None)
    self.hook_invocations = 0
    self.hook_failures = 0

  def addresses(self) -> dict[str, str]:
    return dict(self._backends)

  def alive(self, backend_id: str) -> bool:
    # No process handle: liveness is the health probe's judgment, and
    # the probe already runs every tick. Answering False here would
    # short-circuit the wedge counter with information we don't have.
    return str(backend_id) in self._backends

  def kill(self, backend_id: str, sig=signal.SIGKILL) -> None:
    # Nothing local to kill; the hook (if any) owns the remote process.
    self._log(f"remote pool: kill({backend_id}) is a no-op on a "
              "joined fleet")

  def restart(self, backend_id: str) -> str:
    """Nudge the remote owner. With a hook: run it (nonzero exit or
    spawn failure raises — counted by the supervisor, never fatal).
    Without: a no-op 'restart' — probes decide recovery next tick."""
    backend_id = str(backend_id)
    address = self._backends.get(backend_id)
    if address is None:
      raise KeyError(f"unknown backend {backend_id!r}")
    if self._hook_argv is None:
      self._log(f"remote pool: no --restart-hook; leaving {backend_id} "
                "to its owner (probes decide recovery)")
      return address
    argv = self._hook_argv + [backend_id, address]
    self.hook_invocations += 1
    try:
      result = self._runner(argv, timeout=self.hook_timeout_s,
                            capture_output=True)
      rc = result.returncode
    except Exception as e:  # noqa: BLE001 - a broken hook is a failed spawn
      self.hook_failures += 1
      raise BackendSpawnError(
          f"restart hook {argv[0]!r} failed for {backend_id}: {e!r}")
    if rc != 0:
      self.hook_failures += 1
      raise BackendSpawnError(
          f"restart hook {argv[0]!r} exited {rc} for {backend_id}")
    self._log(f"remote pool: restart hook ok for {backend_id}")
    return address

  def add_address(self, backend_id: str, address: str) -> None:
    """Register a backend some provisioner just created (the
    autoscaler's ``--provision-hook`` hands the new address here so the
    next probe pass supervises it like any other member)."""
    self._backends[str(backend_id)] = str(address)
    self._log(f"remote pool: registered {backend_id} at {address}")

  def retire(self, backend_id: str) -> None:
    """Forget a backend (scale-down on a joined fleet): the remote
    process belongs to its owner — only the membership entry goes.
    Idempotent, like ``BackendPool.retire``."""
    if self._backends.pop(str(backend_id), None) is not None:
      self._log(f"remote pool: {backend_id} retired (process left to "
                "its owner)")

  def snapshot(self) -> dict:
    return {
        "backends": dict(self._backends),
        "restart_hook": self.restart_hook,
        "hook_invocations": self.hook_invocations,
        "hook_failures": self.hook_failures,
    }

  def close(self) -> None:
    pass  # nothing owned, nothing to reap

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


def _shlex_split(cmd: str) -> list[str]:
  import shlex

  return shlex.split(cmd)
