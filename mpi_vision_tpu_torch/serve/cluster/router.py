"""The cluster tier's HTTP transport.

PyTorch-package copy of the part of ``mpi_vision_tpu/serve/cluster/
router.py`` the asset tier and the training queue use: ``HttpTransport``
(``serve/assets/fetch.py`` ``warm_backend``'s default transport,
``train/supervisor.py``'s health probes). The router itself (the
consistent-hash ring, per-backend breakers, failover, ``traceparent``
propagation, aggregated ``/stats`` and ``/metrics``) is not ported yet.
"""

from __future__ import annotations

import http.client
import urllib.error
import urllib.request


class HttpTransport:
  """The default HTTP transport (stdlib urllib, no deps).

  ``request`` returns ``(status, headers, body)`` for ANY HTTP response
  (4xx/5xx included — the caller decides what a status means) and raises
  ``ConnectionError`` only when no HTTP conversation happened at all
  (refused, reset, DNS, timeout) — the signal that the *host*, not the
  request, is in trouble.
  """

  def request(self, method: str, url: str, body: bytes | None = None,
              headers: dict | None = None,
              timeout: float = 30.0) -> tuple[int, dict, bytes]:
    req = urllib.request.Request(url, data=body, method=method,
                                 headers=dict(headers or {}))
    try:
      with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, dict(resp.headers.items()), resp.read()
    except urllib.error.HTTPError as e:
      # An HTTP-level error IS a response; read it fully so the caller
      # sees the peer's own error JSON.
      with e:
        return e.code, dict(e.headers.items()), e.read()
    except (urllib.error.URLError, ConnectionError, TimeoutError,
            OSError, http.client.HTTPException) as e:
      # HTTPException (BadStatusLine, IncompleteRead, ...) is NOT an
      # OSError: a half-dead peer writing a garbled status line or
      # truncating mid-read must look like a dead host, not escape as an
      # unclassified exception.
      raise ConnectionError(str(e.reason if isinstance(
          e, urllib.error.URLError) else e) or repr(e)) from e
