"""The port's scene-asset tier (``serve/assets/``) against the JAX tier.

Ports ``tests/serve/test_assets.py``'s cases to the port's tiled
``RenderService`` and holds what crosses a process boundary to the JAX
service's on the same seeded scene: the manifest key by key (apart from
the fields that name the engine), every tile asset and every layer asset
byte for byte, the viewer page. Digests and encodings come from the
registered host arrays in both packages. The tile-diff sync fetches
exactly the changed tiles, over an in-process transport and over real
HTTP between two port services, and the ``serve --asset-sync-from``
follower reports it. The JAX file's router cases run through the port's
``serve/cluster`` router: an unchanged tile's ETag still answers 304
after a partial swap, asset GETs fan past a backend that lacks the
digest, and a replica syncs through the router.

Geometry as in ``test_assets.py``: 16 x 16, 4 planes, tile 8 (2 x 2).
"""

import hashlib
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from mpi_vision_tpu.serve import RenderService as JRenderService
from mpi_vision_tpu.serve.assets import store as jstore
from mpi_vision_tpu_torch import cli
from mpi_vision_tpu_torch.serve import RenderService
from mpi_vision_tpu_torch.serve import tiles as tiles_mod
from mpi_vision_tpu_torch.serve.assets import (
    ASSET_CACHE_CONTROL,
    MANIFEST_VERSION,
    AssetIntegrityError,
    AssetStore,
    SceneFetcher,
    SceneSyncError,
    SceneSyncWatcher,
)
from mpi_vision_tpu_torch.serve.assets import store as store_mod
from mpi_vision_tpu_torch.serve.cluster import Router, make_router_http_server
from mpi_vision_tpu_torch.serve.server import (
    make_http_server,
    synthetic_tiled_scene,
)
from mpi_vision_tpu_torch.viewer import export as viewer_export

H = W = 16
P = 4
TILE = 8  # 2x2 grid
# Manifest fields that name the engine that serves the scene (the edge
# cache's engine digest), not the scene: they differ between packages.
ENGINE_FIELDS = ("params_digest",)


def _scene(seed=0):
  return synthetic_tiled_scene("s", height=H, width=W, planes=P,
                               regions=2, seed=seed)


def _mutate_tile00(layers):
  out = np.array(layers, copy=True)
  out[:TILE, :TILE] = (out[:TILE, :TILE] + 0.125) % 1.0
  return out


def _tiled_svc(layers, depths, k, **kwargs):
  svc = RenderService(device="cpu", max_batch=2,
                      tile=kwargs.pop("tile", TILE), **kwargs)
  svc.add_scene("s", layers, depths, k)
  return svc


@pytest.fixture(scope="module")
def svc():
  layers, depths, k = _scene()
  service = _tiled_svc(layers, depths, k)
  yield service
  service.close()


@pytest.fixture(scope="module")
def jax_svc():
  layers, depths, k = _scene()
  service = JRenderService(max_batch=2, tile=TILE, use_mesh=False,
                           resilience=None)
  service.add_scene("s", layers, depths, k)
  yield service
  service.close()


# -- auto tile sizing -------------------------------------------------------


def test_tile_size_auto_service_derives_per_scene_grid():
  layers, depths, k = _scene()
  auto = _tiled_svc(layers, depths, k, tile="auto")
  explicit = _tiled_svc(layers, depths, k, tile=8)
  try:
    meta = auto.tile_meta("s")
    assert meta.grid.tile == tiles_mod.auto_tile(H, W) == 8
    assert meta.digests == explicit.tile_meta("s").digests
    assert (auto.scene_manifest("s")["tiles"]
            == explicit.scene_manifest("s")["tiles"])
  finally:
    auto.close()
    explicit.close()


def test_untiled_service_has_no_asset_tier():
  untiled = RenderService(device="cpu", max_batch=2)
  try:
    assert untiled.assets is None
    with pytest.raises(RuntimeError, match="tile="):
      untiled.scene_manifest("s")
  finally:
    untiled.close()


# -- manifest + asset contract, held to the JAX service ---------------------


def test_manifest_schema_pin(svc):
  man = svc.scene_manifest("s")
  assert set(man) == {
      "version", "scene_id", "scene_digest", "params_digest", "grid",
      "planes", "dtype", "depths", "intrinsics", "encoding", "tiles",
      "layers", "asset_path",
  }
  assert man["version"] == MANIFEST_VERSION
  assert man["grid"] == {"height": H, "width": W, "tile": TILE,
                         "rows": 2, "cols": 2}
  assert man["planes"] == P and man["dtype"] == "<f4"
  assert man["encoding"] == {"tiles": "raw-f32+zlib", "layers": "png"}
  assert man["asset_path"] == "/scene/s/asset/"
  meta = svc.tile_meta("s")
  assert man["scene_digest"] == meta.scene_digest
  assert man["tiles"] == [[meta.digests[i][j] for j in range(2)]
                          for i in range(2)]
  assert len(man["layers"]) == P
  assert svc.scene_manifest("s") is man  # cached per generation
  with pytest.raises(KeyError):
    svc.scene_manifest("nope")


def test_manifest_equals_the_jax_services_key_by_key(svc, jax_svc):
  ours, theirs = svc.scene_manifest("s"), jax_svc.scene_manifest("s")
  assert set(ours) == set(theirs)
  for key in ours:
    if key in ENGINE_FIELDS:
      assert ours[key].endswith(":tiled") and theirs[key].endswith(":tiled")
      continue
    assert ours[key] == theirs[key], key


def test_tile_assets_byte_identical_to_jax_and_the_host_crop(svc, jax_svc):
  man = svc.scene_manifest("s")
  entry = svc.scene_entry("s")
  meta = svc.tile_meta("s")
  for i in range(2):
    for j in range(2):
      digest = man["tiles"][i][j]
      encoded, serve_meta = svc.scene_asset("s", digest)
      jencoded, jmeta = jax_svc.scene_asset("s", digest)
      assert encoded == jencoded and serve_meta == jmeta
      assert serve_meta["kind"] == "tile"
      assert serve_meta["encoding"] == "raw-f32+zlib"
      raw = store_mod.decode_tile(encoded)
      y0, y1, x0, x1 = meta.grid.rect(i, j)
      assert raw == np.ascontiguousarray(entry[0][y0:y1, x0:x1]).tobytes()
      assert hashlib.sha256(raw).hexdigest() == digest


def test_layer_assets_byte_identical_to_jax_and_the_export_pngs(svc,
                                                                 jax_svc):
  man = svc.scene_manifest("s")
  assert man["layers"] == jax_svc.scene_manifest("s")["layers"]
  layers = svc.scene_entry("s")[0]
  for plane, digest in enumerate(man["layers"]):
    body, serve_meta = svc.scene_asset("s", digest)
    assert body == jax_svc.scene_asset("s", digest)[0]
    assert body == viewer_export.layer_to_png_bytes(layers[:, :, plane])
    assert serve_meta["kind"] == "layer"
    assert serve_meta["content_type"] == "image/png"
    assert body[:8] == b"\x89PNG\r\n\x1a\n"
    assert hashlib.sha256(body).hexdigest() == digest


def test_unknown_digest_is_a_key_error(svc):
  with pytest.raises(KeyError, match="unknown asset digest"):
    svc.scene_asset("s", "0" * 64)


def test_viewer_html_references_assets_and_equals_jax(svc, jax_svc):
  html, scene_digest = svc.scene_viewer_html("s")
  assert scene_digest == svc.tile_meta("s").scene_digest
  for digest in svc.scene_manifest("s")["layers"]:
    assert f"/scene/s/asset/{digest}" in html
  assert "base64" not in html
  assert (html, scene_digest) == jax_svc.scene_viewer_html("s")


def test_evicted_asset_reencodes_bit_identically():
  layers, depths, k = _scene()
  small = _tiled_svc(layers, depths, k, asset_cache_bytes=1)
  try:
    man = small.scene_manifest("s")
    digests = [d for row in man["tiles"] for d in row]
    first = {d: small.scene_asset("s", d)[0] for d in digests}
    assert small.assets.stats()["evictions"] > 0
    again = {d: small.scene_asset("s", d)[0] for d in digests}
    assert first == again
  finally:
    small.close()


def test_corrupt_publish_refused():
  store = AssetStore()
  good = b"the real bytes"
  with pytest.raises(AssetIntegrityError, match="corrupt bake refused"):
    store.put(store_mod.digest_of(good), b"tampered bytes",
              b"tampered bytes", {"kind": "tile"})
  assert store.stats()["rejects"] == 1
  assert store.get(store_mod.digest_of(good)) is None


def test_store_helpers_match_jax():
  raw = np.arange(64, dtype=np.float32).tobytes()
  assert store_mod.encode_tile(raw) == jstore.encode_tile(raw)
  assert store_mod.digest_of(raw) == jstore.digest_of(raw)
  assert store_mod.asset_etag("ab") == jstore.asset_etag("ab")
  assert store_mod.manifest_etag("ab") == jstore.manifest_etag("ab")


def test_asset_metrics_and_stats_blocks(svc):
  snap = svc.metrics.snapshot()
  assert {"manifest_requests", "requests", "not_found", "not_modified",
          "bytes_served", "encodes",
          "publish_rejects"} <= set(snap["assets"])
  assert {"runs", "tiles_fetched", "tiles_reused", "bytes_fetched",
          "failures"} <= set(snap["scene_sync"])
  cache = svc.stats()["assets"]["cache"]
  assert cache["live_digests"] >= 4 and cache["byte_budget"] > 0
  assert "mpi_serve_asset_cache_assets" in svc.metrics_text()


# -- tile-diff sync (socket-free) -------------------------------------------


class FakeTransport:
  """Serve a remote RenderService's asset surface in-process, recording
  every path."""

  def __init__(self, remote):
    self.remote = remote
    self.paths = []
    self.tamper = None

  def get(self, url, headers=None):
    path = url[len("http://origin"):]
    self.paths.append(path)
    try:
      if path == "/scenes":
        return 200, {}, json.dumps(
            {"scenes": self.remote.scene_ids()}).encode()
      if path.endswith("/manifest"):
        sid = path.split("/")[2]
        return 200, {}, json.dumps(self.remote.scene_manifest(sid)).encode()
      sid, digest = path.split("/")[2], path.split("/")[4]
      if self.tamper and digest in self.tamper:
        return 200, {}, self.tamper[digest]
      body, _ = self.remote.scene_asset(sid, digest)
      return 200, {}, body
    except KeyError:
      return 404, {}, b"{}"

  def asset_digests(self):
    return {p.split("/")[4] for p in self.paths if "/asset/" in p}


@pytest.fixture()
def origin():
  layers, depths, k = _scene()
  service = _tiled_svc(layers, depths, k)
  yield service, layers, depths, k
  service.close()


@pytest.fixture()
def replica():
  service = RenderService(device="cpu", max_batch=2, tile=TILE)
  yield service
  service.close()


def test_full_sync_then_in_sync(origin, replica):
  svc, layers, _, _ = origin
  fetcher = SceneFetcher(replica, "http://origin",
                         transport=FakeTransport(svc))
  stats = fetcher.sync_scene("s")
  assert stats["tiles_fetched"] == 4 and stats["tiles_reused"] == 0
  assert stats["bytes_fetched"] > 0
  assert np.array_equal(replica.scene_entry("s")[0], layers)
  assert (replica.tile_meta("s").scene_digest
          == svc.tile_meta("s").scene_digest)
  again = fetcher.sync_scene("s")
  assert again["in_sync"] and again["tiles_fetched"] == 0
  snap = replica.metrics.snapshot()["scene_sync"]
  assert snap["runs"] == 2 and snap["tiles_fetched"] == 4


def test_diff_sync_fetches_exactly_the_changed_tile_set(origin, replica):
  svc, layers, depths, k = origin
  transport = FakeTransport(svc)
  fetcher = SceneFetcher(replica, "http://origin", transport=transport)
  fetcher.sync_scene("s")
  old_meta = svc.tile_meta("s")
  svc.swap_scenes({"s": (_mutate_tile00(layers), depths, k)})
  new_meta = svc.tile_meta("s")
  changed = {new_meta.digests[i][j]
             for (i, j) in old_meta.changed_tiles(new_meta)}
  assert len(changed) == 1
  transport.paths.clear()
  stats = fetcher.sync_scene("s")
  assert stats["tiles_fetched"] == 1 and stats["tiles_reused"] == 3
  assert transport.asset_digests() == changed
  assert np.array_equal(replica.scene_entry("s")[0],
                        svc.scene_entry("s")[0])
  # The replica renders what the origin renders: both are port services
  # on the same tiled plan.
  pose = np.eye(4, dtype=np.float32)
  np.testing.assert_array_equal(replica.render("s", pose),
                                svc.render("s", pose))


def test_corrupt_transfer_never_lands(origin, replica):
  svc, _, _, _ = origin
  transport = FakeTransport(svc)
  fetcher = SceneFetcher(replica, "http://origin", transport=transport)
  fetcher.sync_scene("s")
  before = np.array(replica.scene_entry("s")[0], copy=True)
  digest = svc.scene_manifest("s")["tiles"][0][0]
  transport.tamper = {
      digest: store_mod.encode_tile(b"\x00" * (TILE * TILE * P * 4 * 4))}
  replica2 = RenderService(device="cpu", max_batch=2, tile=TILE)
  try:
    fetcher2 = SceneFetcher(replica2, "http://origin", transport=transport)
    with pytest.raises(SceneSyncError, match="digest verification"):
      fetcher2.sync_scene("s")
    assert replica2.scene_entry("s") is None
    assert replica2.metrics.snapshot()["scene_sync"]["failures"] == 1
  finally:
    replica2.close()
  assert np.array_equal(replica.scene_entry("s")[0], before)


def test_sync_all_counts_failures_and_converges_the_rest(origin, replica):
  svc, _, _, _ = origin
  layers, depths, k = _scene(seed=9)
  svc.add_scene("t", layers, depths, k)
  transport = FakeTransport(svc)
  digest = svc.scene_manifest("t")["tiles"][1][1]
  transport.tamper = {digest: b"not even zlib"}
  fetcher = SceneFetcher(replica, "http://origin", transport=transport)
  sweep = fetcher.sync_all()
  assert sweep["scenes"] == 1 and sweep["failures"] == 1
  assert replica.scene_entry("s") is not None
  assert replica.scene_entry("t") is None


def test_scene_sync_watcher_counts_and_recovers(origin, replica):
  svc, _, _, _ = origin
  transport = FakeTransport(svc)
  fetcher = SceneFetcher(replica, "http://origin", transport=transport)
  watcher = SceneSyncWatcher(fetcher, poll_s=5.0)
  sweep = watcher.check_once()
  assert sweep["scenes"] == 1 and watcher.sync_errors == 0

  class DownTransport:
    def get(self, url, headers=None):
      raise ConnectionError("origin down")

  fetcher.transport = DownTransport()
  assert watcher.check_once() is None
  assert watcher.sync_errors == 1
  assert "origin down" in watcher.snapshot()["last_error"]
  fetcher.transport = transport
  assert watcher.check_once()["in_sync"] == 1
  snap = watcher.snapshot()
  assert snap["polls"] == 3 and snap["source"] == "http://origin"


def test_sync_events_emitted(origin, replica):
  svc, _, _, _ = origin
  fetcher = SceneFetcher(replica, "http://origin",
                         transport=FakeTransport(svc))
  fetcher.sync_scene("s")
  kinds = [e["kind"] for e in replica.events.snapshot(recent=16)["events"]]
  assert "scene_sync_begin" in kinds and "scene_sync_end" in kinds


# -- real HTTP between two port services -----------------------------------


def _get(base, path, etag=None):
  req = urllib.request.Request(base + path)
  if etag:
    req.add_header("If-None-Match", etag)
  try:
    with urllib.request.urlopen(req, timeout=10) as resp:
      return resp.status, dict(resp.headers), resp.read()
  except urllib.error.HTTPError as e:
    with e:
      return e.code, dict(e.headers), e.read()


@pytest.fixture()
def http_origin():
  layers, depths, k = _scene(seed=3)
  service = _tiled_svc(layers, depths, k)
  httpd = make_http_server(service, port=0)
  threading.Thread(target=httpd.serve_forever, daemon=True).start()
  yield service, f"http://127.0.0.1:{httpd.server_address[1]}", (
      layers, depths, k)
  httpd.shutdown()
  httpd.server_close()
  service.close()


def test_http_routes_revalidate_and_survive_a_partial_swap(http_origin):
  svc, base, (layers, depths, k) = http_origin
  status, _, body = _get(base, "/scenes")
  assert status == 200 and json.loads(body) == {"scenes": ["s"]}
  status, headers, body = _get(base, "/scene/s/manifest")
  assert status == 200 and headers["Cache-Control"] == "no-cache"
  man = json.loads(body)
  assert headers["ETag"] == f'"{man["scene_digest"]}"'
  status, _, body = _get(base, "/scene/s/manifest", etag=headers["ETag"])
  assert status == 304 and body == b""
  unchanged = man["tiles"][1][1]
  status, headers, body = _get(base, f"/scene/s/asset/{unchanged}")
  assert status == 200
  assert headers["Cache-Control"] == ASSET_CACHE_CONTROL
  etag = headers["ETag"]
  assert etag == f'"{unchanged}"'
  assert hashlib.sha256(store_mod.decode_tile(body)).hexdigest() == unchanged
  status, headers, body = _get(base, "/scene/s/viewer")
  assert status == 200 and headers["Content-Type"].startswith("text/html")
  assert all(f"/scene/s/asset/{d}" in body.decode() for d in man["layers"])
  svc.swap_scenes({"s": (_mutate_tile00(layers), depths, k)})
  man2 = json.loads(_get(base, "/scene/s/manifest")[2])
  assert man2["scene_digest"] != man["scene_digest"]
  assert man2["tiles"][0][0] != man["tiles"][0][0]
  assert man2["tiles"][1][1] == unchanged
  status, _, body = _get(base, f"/scene/s/asset/{unchanged}", etag=etag)
  assert status == 304 and body == b""
  for path in (f"/scene/s/asset/{'f' * 64}", "/scene/nope/manifest",
               "/scene/s/asset/not-a-digest"):
    assert _get(base, path)[0] == 404
  snap = svc.stats()["assets"]
  assert snap["not_modified"] == 2 and snap["not_found"] >= 2


def test_http_sync_between_two_port_services_fetches_changed_tiles(
    http_origin):
  svc, base, (layers, depths, k) = http_origin
  replica = RenderService(device="cpu", max_batch=2, tile=TILE)
  try:
    fetcher = SceneFetcher(replica, base)
    sweep = fetcher.sync_all()
    assert sweep == {"scenes": 1, "in_sync": 0, "failures": 0,
                     "tiles_fetched": 4, "tiles_reused": 0,
                     "bytes_fetched": sweep["bytes_fetched"]}
    mutated = np.array(layers, copy=True)
    for (y, x) in ((0, 0), (8, 8)):  # two of four tiles
      mutated[y:y + TILE, x:x + TILE] = (
          mutated[y:y + TILE, x:x + TILE] + 0.25) % 1.0
    svc.swap_scenes({"s": (mutated, depths, k)})
    stats = fetcher.sync_scene("s")
    assert stats["tiles_fetched"] == 2 and stats["tiles_reused"] == 2
    assert np.array_equal(replica.scene_entry("s")[0], mutated)
  finally:
    replica.close()


# -- the real-HTTP / router acceptance pin ----------------------------------


@pytest.fixture(scope="module")
def fleet():
  """One scene-holding backend + one empty backend behind a real port
  router — asset GETs must answer from whichever replica holds the
  digest."""
  layers, depths, k = _scene(seed=3)
  svc = _tiled_svc(layers, depths, k)
  empty = RenderService(device="cpu", max_batch=2, tile=TILE)
  servers = [make_http_server(svc, port=0), make_http_server(empty, port=0)]
  for server in servers:
    threading.Thread(target=server.serve_forever, daemon=True).start()
  router = Router()
  router.add_backend("holder", f"127.0.0.1:{servers[0].server_address[1]}")
  router.add_backend("empty", f"127.0.0.1:{servers[1].server_address[1]}")
  rsrv = make_router_http_server(router, port=0)
  threading.Thread(target=rsrv.serve_forever, daemon=True).start()
  base = f"http://127.0.0.1:{rsrv.server_address[1]}"
  yield svc, router, base, (layers, depths, k)
  rsrv.shutdown()
  router.close()
  for server in servers:
    server.shutdown()
    server.server_close()
  svc.close()
  empty.close()


def test_unchanged_tiles_survive_partial_swap_through_router(fleet):
  svc, router, base, (layers, depths, k) = fleet
  status, headers, body = _get(base, "/scene/s/manifest")
  assert status == 200 and headers["Cache-Control"] == "no-cache"
  man = json.loads(body)
  unchanged = man["tiles"][1][1]  # tile (1,1): the swap won't touch it

  status, headers, body = _get(base, f"/scene/s/asset/{unchanged}")
  assert status == 200
  assert headers["Cache-Control"] == ASSET_CACHE_CONTROL
  etag = headers["ETag"]
  assert etag == f'"{unchanged}"'  # strong, content-derived
  assert hashlib.sha256(store_mod.decode_tile(body)).hexdigest() == unchanged

  svc.swap_scenes({"s": (_mutate_tile00(layers), depths, k)})

  status, _, body = _get(base, "/scene/s/manifest")
  man2 = json.loads(body)
  assert man2["scene_digest"] != man["scene_digest"]
  assert man2["tiles"][0][0] != man["tiles"][0][0]  # the changed tile
  assert man2["tiles"][1][1] == unchanged  # URL/digest stable across swap
  # THE pin: a conditional GET on the unchanged tile's ETag answers 304
  # through the real router — the client's immutable copy is still good.
  status, headers, body = _get(base, f"/scene/s/asset/{unchanged}", etag=etag)
  assert status == 304 and body == b""
  # And an unconditional re-fetch is byte-identical.
  status, headers, body = _get(base, f"/scene/s/asset/{unchanged}")
  assert status == 200 and headers["ETag"] == etag


def test_router_fans_asset_gets_past_404s(fleet):
  svc, router, base, _ = fleet
  digest = json.loads(_get(base, "/scene/s/manifest")[2])["tiles"][0][1]
  before = router.metrics.snapshot()["scene_sync"]
  # Whatever the placement order, the GET must land on the holder.
  status, headers, body = _get(base, f"/scene/s/asset/{digest}")
  assert status == 200 and headers["X-Backend-Id"] == "holder"
  status, _, _ = _get(base, f"/scene/s/asset/{'f' * 64}")
  assert status == 404
  after = router.metrics.snapshot()["scene_sync"]
  assert after["asset_misses"] == before["asset_misses"] + 1
  assert after["asset_forwards"] >= before["asset_forwards"] + 1


def test_scenes_union_and_sync_through_router(fleet):
  svc, router, base, _ = fleet
  status, _, body = _get(base, "/scenes")
  assert status == 200 and json.loads(body) == {"scenes": ["s"]}
  replica = RenderService(device="cpu", max_batch=2, tile=TILE)
  try:
    fetcher = SceneFetcher(replica, base)  # real HTTP, through the router
    sweep = fetcher.sync_all()
    assert sweep["scenes"] == 1 and sweep["failures"] == 0
    assert np.array_equal(replica.scene_entry("s")[0],
                          svc.scene_entry("s")[0])
  finally:
    replica.close()


def test_warm_backend_by_manifest_then_by_render(http_origin):
  """``warm_backend``'s two probes over real HTTP: a backend whose manifest
  digest equals a donor's is warm by manifest; with no donor, a 200 from
  an identity-pose ``/render`` warms it; an unknown scene never warms."""
  from mpi_vision_tpu_torch.serve.assets.fetch import warm_backend

  _, base, _ = http_origin
  host = base[len("http://"):]
  out = warm_backend(host, ["s"], donors=[host], timeout_s=10.0)
  assert out["ok"] and out["modes"] == {"s": "manifest"}
  out = warm_backend(host, ["s"], timeout_s=10.0)
  assert out["ok"] and out["modes"] == {"s": "render"}
  out = warm_backend(host, ["nope"], timeout_s=0.3, poll_s=0.05)
  assert not out["ok"] and out["failed"] == ["nope"]


def test_serve_cli_follower_syncs_by_tile_diff(http_origin, tmp_path):
  svc, base, (layers, depths, k) = http_origin
  port_file = str(tmp_path / "port")
  out = {}

  def follow():
    out["summary"] = cli.cmd_serve(cli.build_parser().parse_args([
        "serve", "--device", "cpu", "--tiled", "--tile-size", str(TILE),
        "--scenes", "0", "--asset-sync-from", base,
        "--asset-sync-interval-s", "0.2", "--port", "0",
        "--port-file", port_file, "--duration", "4"]))

  thread = threading.Thread(target=follow)
  thread.start()
  deadline = time.monotonic() + 20
  while not os.path.exists(port_file) and time.monotonic() < deadline:
    time.sleep(0.05)
  follower = f"http://127.0.0.1:{open(port_file).read()}"
  while time.monotonic() < deadline:
    stats = json.loads(_get(follower, "/stats")[2])
    if stats["scene_sync"]["tiles_fetched"] >= 4:
      break
    time.sleep(0.05)
  svc.swap_scenes({"s": (_mutate_tile00(layers), depths, k)})
  while time.monotonic() < deadline:
    stats = json.loads(_get(follower, "/stats")[2])
    if stats["scene_sync"]["tiles_fetched"] >= 5:
      break
    time.sleep(0.05)
  thread.join(30)
  assert not thread.is_alive()
  sync = out["summary"]["scene_sync"]
  assert sync["sync_errors"] == 0 and sync["polls"] >= 2
  assert stats["scene_sync"]["tiles_fetched"] == 5  # 4, then the 1 changed
  assert out["summary"]["scenes"] == 1


def test_serve_cli_refuses_asset_flags_without_tiled():
  for argv, msg in ((["--asset-cache-mb", "8"], "--tiled"),
                    (["--asset-sync-from", "http://x"], "--tiled"),
                    (["--tiled", "--asset-sync-interval-s", "1"],
                     "--asset-sync-from"),
                    (["--tiled", "--asset-cache-mb", "0"], ">= 1")):
    with pytest.raises(SystemExit, match=msg):
      cli.cmd_serve(cli.build_parser().parse_args(
          ["serve", "--device", "cpu", *argv]))
