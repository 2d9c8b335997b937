"""Session streaming: pose-in / frame-out sessions over the render stack.

PyTorch-package copy of ``mpi_vision_tpu/serve/session/`` (host-only
Python over the port's ``RenderService``; session frames render through
``render_request`` and so through the CUDA kernels).

The session tier makes the *session*, not the frame, the unit of serving
(Potamoi's streaming-architecture lesson, PAPERS.md): a client opens one
long-lived ``POST /session`` exchange, streams length-prefixed poses in,
and receives length-prefixed rendered frames out — while the server-side
``SessionManager`` turns the session's standing state into three wins a
request-per-frame protocol cannot have:

  * **same-scene flight fusion** (``manager.py``): a session's queued
    poses are same-scene by construction, so each drain submits them
    concurrently and the scheduler coalesces them into one device
    dispatch.
  * **trajectory-predictive prefetch** (``predictor.py`` +
    ``manager.py``): a constant-velocity/EMA pose predictor maps the
    predicted camera path onto edge-cache view cells and issues
    speculative ``prefetch``-class renders for not-yet-resident cells,
    so the real pose hits.
  * **full per-request semantics**: every session frame rides the
    service's normal front door (``render_request``) — brownout
    admission, retry/breaker, SLO, and attribution all see it.

``protocol.py`` owns the wire framing and a minimal blocking client.
"""

from mpi_vision_tpu_torch.serve.session.manager import (  # noqa: F401 - API re-exports
    Session,
    SessionConfig,
    SessionLimitError,
    SessionManager,
)
from mpi_vision_tpu_torch.serve.session.predictor import (  # noqa: F401
    TrajectoryPredictor,
)
from mpi_vision_tpu_torch.serve.session.protocol import (  # noqa: F401
    ProtocolError,
    SessionClient,
    SessionOpenError,
)
