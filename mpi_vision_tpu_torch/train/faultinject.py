"""Supervisor-visible training faults, driven from job specs / CLI flags.

``ckpt/faultinject.py`` owns the *mechanism* (``TrainFaultSource``:
scheduled crash / NaN / preempt / hang / corrupt faults consumed by
``fit_resumable`` and the checkpoint store). This module owns the
*wire format*: a compact one-string-per-fault grammar that rides a job
spec's ``faults`` list and the ``train --inject-fault`` flag, so the
training queue's chaos drills (crash-at-step, hang-until-wedged,
corrupt-then-exit, preempt) replay exactly across real subprocesses.

Grammar (``KIND@WHEN[,OPT[=VAL]...]``)::

    crash@step=3            raise SimulatedCrash before global step 3
    crash@step=3,hard       SIGKILL the process there instead (no atexit)
    nan@step=2              poison that step's batch (NaN-guard food)
    preempt@step=4          set the preemption flag (SIGTERM semantics)
    hang@step=2,seconds=600 sleep before the step (stall-watchdog /
                            queue-supervisor wedge food; a SIGKILL from
                            the supervisor ends it early)
    crash@save=1,stage=pre_rename   die mid-save (atomicity pin)
    corrupt@save=1[,target=arrays.npz][,mode=garble]
                            corrupt the published save (with a later
                            ``crash@step=...`` this is corrupt-then-exit:
                            the resume must quarantine and fall back)

An ``attempt=N`` option gates the fault to one queue attempt (0-based);
without it the fault fires on EVERY attempt — that is what makes a
poison job crash-loop into its restart budget, while an ``attempt=0``
crash exercises the requeue-then-resume-bit-exact path.
"""

from __future__ import annotations

from mpi_vision_tpu_torch.ckpt.faultinject import TrainFault, TrainFaultSource

_STEP_KINDS = ("crash", "nan", "preempt", "hang")
_SAVE_KINDS = ("crash", "corrupt")
_FLAGS = ("hard",)
_VALUED = ("step", "save", "seconds", "stage", "target", "mode", "attempt")
# Every key a dict-form fault entry may carry (the string grammar's
# vocabulary): anything else is a typo that must reject, not vanish.
_DICT_KEYS = frozenset(("kind",) + _FLAGS + _VALUED)


class FaultSpecError(ValueError):
  """A fault spec string failed to parse (the CLI maps it to exit 2)."""


def parse_fault(spec: str) -> dict:
  """One spec string -> a plain dict ``{"kind", "attempt", ...}``.

  The dict form is what rides a job spec's ``faults`` list (JSON);
  ``build_source`` turns a list of them into a ``TrainFaultSource``.
  """
  spec = spec.strip()
  kind, sep, rest = spec.partition("@")
  kind = kind.strip()
  if not sep or kind not in set(_STEP_KINDS) | set(_SAVE_KINDS):
    raise FaultSpecError(
        f"fault spec {spec!r}: expected KIND@WHEN with KIND in "
        f"{sorted(set(_STEP_KINDS) | set(_SAVE_KINDS))}")
  out: dict = {"kind": kind, "attempt": None}
  for part in rest.split(","):
    part = part.strip()
    if not part:
      continue
    key, eq, value = part.partition("=")
    key = key.strip()
    if not eq:
      if key not in _FLAGS:
        raise FaultSpecError(f"fault spec {spec!r}: unknown flag {key!r}")
      out[key] = True
      continue
    if key not in _VALUED:
      raise FaultSpecError(f"fault spec {spec!r}: unknown option {key!r}")
    value = value.strip()
    if key in ("step", "save", "attempt"):
      try:
        out[key] = int(value)
      except ValueError:
        raise FaultSpecError(
            f"fault spec {spec!r}: {key} must be an integer, got {value!r}")
    elif key == "seconds":
      try:
        out[key] = float(value)
      except ValueError:
        raise FaultSpecError(
            f"fault spec {spec!r}: seconds must be a number, got {value!r}")
    else:
      out[key] = value
  has_step, has_save = "step" in out, "save" in out
  if has_step == has_save:
    raise FaultSpecError(
        f"fault spec {spec!r}: exactly one of step=/save= is required")
  if has_step and kind not in _STEP_KINDS:
    raise FaultSpecError(f"fault spec {spec!r}: {kind!r} is not a step fault")
  if has_save and kind not in _SAVE_KINDS:
    raise FaultSpecError(f"fault spec {spec!r}: {kind!r} is not a save fault")
  return out


def format_fault(fault: dict) -> str:
  """The inverse of ``parse_fault`` (how the queue supervisor forwards a
  job spec's fault dicts to the ``train --inject-fault`` argv)."""
  kind = fault["kind"]
  when = ("step", fault["step"]) if "step" in fault else ("save",
                                                          fault["save"])
  parts = [f"{kind}@{when[0]}={when[1]}"]
  if fault.get("hard"):
    parts.append("hard")
  for key in ("seconds", "stage", "target", "mode"):
    if fault.get(key) is not None and key in fault:
      parts.append(f"{key}={fault[key]}")
  if fault.get("attempt") is not None:
    parts.append(f"attempt={fault['attempt']}")
  return ",".join(parts)


def _entries(faults) -> list[dict]:
  """Normalize a spec's ``faults`` payload to validated dicts.

  Job specs arrive as JSON, so entries may be strings OR dicts (or
  garbage): anything malformed must raise ``FaultSpecError`` here —
  the launcher converts it to a terminal spec-reject — never a bare
  KeyError/TypeError that would strand the job in a lease-reap-respawn
  loop the restart budget can't see.
  """
  if faults is None:
    return []
  if isinstance(faults, (str, bytes, dict)) or not hasattr(faults,
                                                           "__iter__"):
    raise FaultSpecError(
        f"faults must be a list of fault specs, got {faults!r}")
  out = []
  for fault in faults:
    if isinstance(fault, str):
      out.append(parse_fault(fault))
    elif isinstance(fault, dict):
      # format_fault emits only keys it knows, so a typo'd key (say
      # "atempt") would silently vanish in the round-trip — turning an
      # attempt-gated one-shot crash into an every-attempt poison fault.
      unknown = set(fault) - _DICT_KEYS
      if unknown:
        raise FaultSpecError(
            f"bad fault entry {fault!r}: unknown key(s) {sorted(unknown)} "
            f"(allowed: {sorted(_DICT_KEYS)})")
      try:
        # Round-trip through the grammar: format re-checks the required
        # keys, parse re-validates every value.
        out.append(parse_fault(format_fault(fault)))
      except (KeyError, TypeError, ValueError) as e:
        if isinstance(e, FaultSpecError):
          raise
        raise FaultSpecError(f"bad fault entry {fault!r}: {e!r}")
    else:
      raise FaultSpecError(f"bad fault entry {fault!r}")
  return out


def _to_train_fault(fault: dict) -> TrainFault:
  kwargs = {"kind": fault["kind"]}
  if fault.get("hard"):
    kwargs["hard"] = True
  for key in ("stage", "target", "mode", "seconds"):
    if fault.get(key) is not None and key in fault:
      kwargs[key] = fault[key]
  try:
    return TrainFault(**kwargs)
  except ValueError as e:
    raise FaultSpecError(str(e))


def build_source(faults, attempt: int | None = None
                 ) -> TrainFaultSource | None:
  """A ``TrainFaultSource`` armed with every applicable fault.

  ``faults`` is a list of spec strings or ``parse_fault`` dicts.
  ``attempt`` filters attempt-gated faults (``attempt=N`` fires only on
  queue attempt N; ungated faults always arm) — None arms everything
  (the bare ``train --inject-fault`` path, which has no attempt notion).
  Returns None when nothing applies, so the loop takes its zero-overhead
  ``fault_source=None`` branch.
  """
  armed = []
  for fault in _entries(faults):
    gate = fault.get("attempt")
    if attempt is not None and gate is not None and int(gate) != attempt:
      continue
    armed.append(fault)
  if not armed:
    return None
  source = TrainFaultSource()
  for fault in armed:
    tf = _to_train_fault(fault)
    if "step" in fault:
      source.at_step(int(fault["step"]), tf)
    else:
      source.at_save(int(fault["save"]), tf)
  return source


def applicable(faults, attempt: int) -> list[str]:
  """The spec strings to forward to one attempt's subprocess argv."""
  out = []
  for fault in _entries(faults):
    gate = fault.get("attempt")
    if gate is not None and int(gate) != attempt:
      continue
    out.append(format_fault(fault))
  return out
