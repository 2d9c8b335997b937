"""MPI viewer export: layer PNGs + a self-contained CSS-3D HTML viewer.

PyTorch-package copy of ``mpi_vision_tpu/viewer/export.py`` (host-only,
numpy and PIL): the same template and the same encoders, so both packages
write byte-identical HTML for the same layers.

Reference behavior (notebook cell 18 + deepview-mpi-viewer-template.html):
RGBA layers in [-1, 1] are rescaled to [0, 1] (alpha passed through), saved
as PNGs, base64-embedded into an HTML page that renders the MPI with CSS
``preserve-3d`` transforms — layers spaced uniformly in inverse depth with
index 0 farthest, each pre-scaled so the stack aligns exactly when viewed
head-on and produces parallax under pose changes.

The HTML here is an original implementation of that behavior (not a copy of
the reference template): a ``perspective: f px`` stage whose focal length is
``0.5 * w / tan(fov/2)`` (the reference's focal model, template:304), layers
at ``translateZ(-z) scale((f+z)/f)`` with ``z = f * (d/d_near - 1)``, and
pointer controls — move for parallax, drag to rotate, shift-drag to
translate, wheel to dolly, digit keys to inspect single layers, ``a`` for
alpha view.

Inspection/motion features matching the reference template's surface:
depth-colormap modes (``d`` cycles off/turbo/magma — procedural colormaps
tinting each layer through its own alpha mask; template:220-267), sway and
wander auto-motion (``s``/``w``; template:488-495, 620-639), a clickable
per-layer minis bar with solo/under/over selection (``[``/``]``, ``m``;
template:506-598), and URL parameters — ``url``/``n`` load an external
``mpi$$.png`` sequence instead of the embedded MPI, plus
``near``/``far``/``fov``/``move``/``depth``/``mini``/``solo`` overrides
(template:641-686).
"""

from __future__ import annotations

import base64
import io
import os
from typing import Sequence

import numpy as np

_HTML_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>MPI viewer — mpi_vision_tpu</title>
<style>
  html, body { margin: 0; background: #111; height: 100%; overflow: hidden;
               font: 12px monospace; color: #ccc; }
  #stage { position: absolute; inset: 0; display: flex;
           align-items: center; justify-content: center; }
  #frustum { position: relative; transform-style: preserve-3d; }
  .layer { position: absolute; left: 0; top: 0; width: 100%; height: 100%;
           transform-style: preserve-3d; backface-visibility: hidden;
           pointer-events: none; }
  .layer .tint { position: absolute; inset: 0; display: none; }
  .depthmap .layer img { visibility: hidden; }
  .depthmap .layer .tint { display: block; }
  .alpha .layer img { filter: grayscale(1) contrast(0); }
  /* Excluded-layer silhouettes (the reference's white/black feColorMatrix
     inspection filters, template:693-698): keep the alpha shape, flatten
     the RGB to black or white. */
  body.silh-black .layer.excluded img { filter: brightness(0); }
  body.silh-white .layer.excluded img { filter: brightness(0) invert(1); }
  #hud { position: fixed; left: 8px; bottom: 8px; opacity: .7;
         user-select: none; }
  #minis { position: fixed; right: 8px; top: 8px; bottom: 8px; width: 96px;
           overflow-y: auto; display: flex; flex-direction: column;
           gap: 4px; }
  #minis img { width: 100%; border: 1px solid #333; cursor: pointer;
               background: #222; }
  #minis img.sel { border-color: #fc0; }
  body.nominis #minis { display: none; }
</style>
</head>
<body>
<div id="stage"><div id="frustum"></div></div>
<div id="minis"></div>
<div id="hud">drag: rotate · shift-drag: pan · wheel: dolly ·
1-9/0: solo · [: under · ]: over · x: dim/black/white others ·
a: alpha · d: depth map · s: sway · w: wander · m: minis · r: reset</div>
<script>
"use strict";
const embeddedSources = __MPI_SOURCES__;
const cfg = { w: __W__, h: __H__, near: __NEAR__, far: __FAR__,
              fov: __FOV__, move: "none", depth: 0, mini: 1, solo: -1 };

// ---- URL parameters: viewing config + external mpi$$.png sequences -----
// ?url=lores/scene/rgba_$$.png&n=10 loads an external MPI instead of the
// embedded one ($$ -> zero-padded index); near/far/fov/move/depth/mini/solo
// override the embedded defaults.
const q = new URLSearchParams(location.search);
let mpiSources = embeddedSources;
if (q.get("url") && q.get("n")) {
  const n = +q.get("n");
  if (Number.isInteger(n) && n > 0) {
    mpiSources = [];
    for (let i = 0; i < n; i++) {
      mpiSources.push(q.get("url").replace("$$", String(i).padStart(2, "0")));
    }
  } else {
    console.warn(`ignoring ?url: n=${q.get("n")} is not a positive integer`);
  }
}
for (const k of ["near", "far", "fov", "depth", "mini", "solo"]) {
  if (q.get(k) !== null) {
    const v = +q.get(k);
    // near/far/fov must be finite AND positive (1/near, tan(fov/2) blow up
    // at 0); a bad value falls back to the embedded default with a warning.
    const ok = Number.isFinite(v)
        && (!["near", "far", "fov"].includes(k) || v > 0);
    if (ok) cfg[k] = v;
    else console.warn(`ignoring ?${k}=${q.get(k)}`);
  }
}
if (q.get("move")) cfg.move = q.get("move");

const focal = 0.5 * cfg.w / Math.tan(cfg.fov * Math.PI / 360);
const P = mpiSources.length;
// Inverse-depth uniform spacing, index 0 = farthest (matches inv_depths).
const depths = [];
for (let i = 0; i < P; i++) {
  const inv = 1 / cfg.far + (1 / cfg.near - 1 / cfg.far) * (P > 1 ? i / (P - 1) : 1);
  depths.push(1 / inv);
}

// ---- depth colormaps (procedural; original implementations) ------------
// turbo: rational-polynomial fit of the published colormap; magma: lerped
// anchor table. t in [0, 1] -> "rgb(...)" (t = 0 far, t = 1 near).
function turbo(t) {
  t = Math.min(1, Math.max(0, t));
  const r = 34.61 + t * (1172.33 + t * (-10793.56 + t * (33300.12 + t * (-38394.49 + t * 14825.05))));
  const g = 23.31 + t * (557.33 + t * (1225.33 + t * (-3574.96 + t * (1073.77 + t * 707.56))));
  const b = 27.2 + t * (3211.1 + t * (-15327.97 + t * (27814.0 + t * (-22569.18 + t * 6838.66))));
  const c = v => Math.round(Math.min(255, Math.max(0, v)));
  return `rgb(${c(r)},${c(g)},${c(b)})`;
}
const MAGMA_ANCHORS = [
  [0, 0, 4], [28, 16, 68], [79, 18, 123], [129, 37, 129], [181, 54, 122],
  [229, 80, 100], [251, 135, 97], [254, 194, 135], [252, 253, 191]];
function magma(t) {
  t = Math.min(1, Math.max(0, t)) * (MAGMA_ANCHORS.length - 1);
  const i = Math.min(MAGMA_ANCHORS.length - 2, Math.floor(t)), f = t - i;
  const mix = (a, b) => Math.round(a + (b - a) * f);
  const lo = MAGMA_ANCHORS[i], hi = MAGMA_ANCHORS[i + 1];
  return `rgb(${mix(lo[0], hi[0])},${mix(lo[1], hi[1])},${mix(lo[2], hi[2])})`;
}
const COLORMAPS = [null, turbo, magma];

const frustum = document.getElementById("frustum");
const stage = document.getElementById("stage");
const minisBar = document.getElementById("minis");
frustum.style.width = cfg.w + "px";
frustum.style.height = cfg.h + "px";
stage.style.perspective = focal + "px";

const layers = [], minis = [];
for (let i = 0; i < P; i++) {
  const div = document.createElement("div");
  div.className = "layer";
  const img = document.createElement("img");
  img.src = mpiSources[i];
  img.style.width = "100%"; img.style.height = "100%";
  div.appendChild(img);
  // Depth-map tint: a colored pane masked by the layer's own alpha.
  const tint = document.createElement("div");
  tint.className = "tint";
  tint.style.maskImage = `url("${mpiSources[i]}")`;
  tint.style.webkitMaskImage = `url("${mpiSources[i]}")`;
  tint.style.maskSize = "100% 100%";
  tint.style.webkitMaskSize = "100% 100%";
  div.appendChild(tint);
  // z grows with scene depth relative to the nearest layer; (f+z)/f undoes
  // the perspective shrink so the stack aligns exactly head-on.
  const z = focal * (depths[i] / depths[P - 1] - 1);
  div.style.transform =
      `translateZ(${-z}px) scale(${(focal + z) / focal})`;
  div.dataset.z = z;
  frustum.appendChild(div);
  layers.push(div);

  // Layer mini: click = solo, shift-click = this-and-under,
  // alt-click = this-and-over; click the selection again to clear.
  const mini = document.createElement("img");
  mini.src = mpiSources[i];
  mini.title = `layer ${i} (depth ${depths[i].toFixed(2)})`;
  mini.addEventListener("click", e => {
    const mode = e.shiftKey ? "under" : (e.altKey ? "over" : "solo");
    if (sel.index === i && sel.mode === mode) {
      sel.index = -1;
    } else {
      sel.index = i; sel.mode = mode;
    }
    apply();
  });
  minisBar.prepend(mini);   // nearest layer on top, like the stack
  minis.push(mini);
}

// Drag rotation accumulates into `base`; hover parallax and the motion
// modes are additive offsets on top, so neither snaps the view back.
const base = { rx: 0, ry: 0, tx: 0, ty: 0, tz: 0 };
const hover = { rx: 0, ry: 0 };
const auto = { rx: 0, ry: 0 };
const sel = { index: cfg.solo, mode: "solo" };
let depthMode = cfg.depth % COLORMAPS.length;
let silhMode = "dim";             // dim | black | white (excluded layers)
let moveMode = cfg.move;          // none | sway | wander
let dragging = false, lastX = 0, lastY = 0;
if (!cfg.mini) document.body.classList.add("nominis");

function visible(i) {
  if (sel.index < 0) return true;
  if (sel.mode === "solo") return i === sel.index;
  if (sel.mode === "under") return i <= sel.index;
  return i >= sel.index;          // over
}

function setSilhMode(mode) {
  silhMode = mode;                // dim | black | white
  document.body.classList.toggle("silh-black", mode === "black");
  document.body.classList.toggle("silh-white", mode === "white");
}

function setDepthMode(mode) {
  // Tint colors depend only on (layer index, mode): set them here once,
  // not in the per-frame apply() path.
  depthMode = mode % COLORMAPS.length;
  document.body.classList.toggle("depthmap", depthMode > 0);
  if (depthMode > 0) {
    layers.forEach((l, i) => {
      const t = P > 1 ? i / (P - 1) : 1;   // 0 = farthest
      l.querySelector(".tint").style.background = COLORMAPS[depthMode](t);
    });
  }
}

function setMoveMode(mode) {
  moveMode = mode;
  if (mode === "none") { auto.rx = auto.ry = 0; }  // no stale swing offset
}

function apply() {
  frustum.style.transform =
      `translate3d(${base.tx}px, ${base.ty}px, ${base.tz}px) ` +
      `rotateX(${base.rx + hover.rx + auto.rx}deg) ` +
      `rotateY(${base.ry + hover.ry + auto.ry}deg)`;
  layers.forEach((l, i) => {
    const vis = visible(i);
    l.classList.toggle("excluded", !vis);
    // Depth-map mode shows tint panes, which the silhouette img filters
    // cannot reach — keep excluded layers dimmed there so the selection
    // stays visible.
    const silh = silhMode !== "dim" && depthMode === 0;
    l.style.opacity = vis ? 1 : (silh ? 1 : 0.04);
  });
  minis.forEach((m, i) => m.classList.toggle("sel",
      sel.index >= 0 && visible(i)));
}

// Motion modes: sway is a gentle fixed-frequency pan; wander is a slow
// two-frequency Lissajous drift over both axes.
function tick(ms) {
  const t = ms / 1000;
  if (moveMode === "sway") {
    auto.ry = 4 * Math.sin(t * 1.1); auto.rx = 0;
  } else if (moveMode === "wander") {
    auto.ry = 3.5 * Math.sin(t * 0.53) + 1.5 * Math.sin(t * 1.31);
    auto.rx = 2.0 * Math.sin(t * 0.71) + 1.0 * Math.cos(t * 0.37);
  } else {
    auto.rx = auto.ry = 0;
  }
  if (moveMode !== "none") apply();
  requestAnimationFrame(tick);
}

window.addEventListener("pointerdown", e => {
  dragging = true; lastX = e.clientX; lastY = e.clientY;
});
window.addEventListener("pointerup", () => dragging = false);
window.addEventListener("pointermove", e => {
  if (dragging) {
    if (e.shiftKey) {
      base.tx += e.clientX - lastX; base.ty += e.clientY - lastY;
    } else {
      base.ry += (e.clientX - lastX) * 0.15;
      base.rx -= (e.clientY - lastY) * 0.15;
    }
    lastX = e.clientX; lastY = e.clientY;
  } else {
    hover.ry = (e.clientX / innerWidth - 0.5) * 6;
    hover.rx = -(e.clientY / innerHeight - 0.5) * 6;
  }
  apply();
});
window.addEventListener("wheel", e => {
  base.tz -= e.deltaY * 0.5; apply();
});
window.addEventListener("keydown", e => {
  if (e.key >= "0" && e.key <= "9") {
    const k = e.key === "0" ? 9 : +e.key - 1;
    if (k < P && !(sel.index === k && sel.mode === "solo")) {
      sel.index = k; sel.mode = "solo";
    } else sel.index = -1;
  } else if (e.key === "[" && sel.index >= 0) {
    sel.mode = "under";
  } else if (e.key === "]" && sel.index >= 0) {
    sel.mode = "over";
  } else if (e.key === "x") {
    setSilhMode(silhMode === "dim" ? "black"
        : (silhMode === "black" ? "white" : "dim"));
  } else if (e.key === "a") {
    document.body.classList.toggle("alpha");
  } else if (e.key === "d") {
    setDepthMode(depthMode + 1);
  } else if (e.key === "s") {
    setMoveMode(moveMode === "sway" ? "none" : "sway");
  } else if (e.key === "w") {
    setMoveMode(moveMode === "wander" ? "none" : "wander");
  } else if (e.key === "m") {
    document.body.classList.toggle("nominis");
  } else if (e.key === "r") {
    Object.assign(base, { rx: 0, ry: 0, tx: 0, ty: 0, tz: 0 });
    sel.index = -1; setDepthMode(0); setMoveMode("none");
    setSilhMode("dim");
  }
  apply();
});
setDepthMode(depthMode);
setMoveMode(moveMode);
apply();
requestAnimationFrame(tick);
</script>
</body>
</html>
"""


def layer_to_png_bytes(rgba: np.ndarray) -> bytes:
  """One ``[H, W, 4]`` RGBA layer in [-1, 1] -> PNG bytes.

  RGB is rescaled [-1, 1] -> [0, 1]; alpha is passed through as-is (already
  (0, 1) from the MPI assembly) — the reference's ``save_image`` (cell 18).
  """
  from PIL import Image

  rgb = np.rint(
      np.clip((rgba[..., :3] + 1.0) / 2.0, 0, 1) * 255).astype(np.uint8)
  a = np.rint(np.clip(rgba[..., 3:], 0, 1) * 255).astype(np.uint8)
  buf = io.BytesIO()
  Image.fromarray(np.concatenate([rgb, a], -1), "RGBA").save(buf, "PNG")
  return buf.getvalue()


def save_layer_pngs(rgba_layers: np.ndarray, out_dir: str,
                    prefix: str = "mpi") -> list[str]:
  """Save ``[H, W, P, 4]`` layers as ``<prefix>00.png ...`` (cell 18)."""
  os.makedirs(out_dir, exist_ok=True)
  paths = []
  for i in range(rgba_layers.shape[2]):
    path = os.path.join(out_dir, f"{prefix}{i:02d}.png")
    with open(path, "wb") as f:
      f.write(layer_to_png_bytes(np.asarray(rgba_layers[:, :, i])))
    paths.append(path)
  return paths


def to_data_uri(png_bytes: bytes) -> str:
  return "data:image/png;base64," + base64.b64encode(png_bytes).decode()


def render_viewer_html(sources: list, w: int, h: int,
                       near: float = 1.0, far: float = 100.0,
                       fov_deg: float = 60.0) -> str:
  """Template the CSS-3D viewer against ``sources`` (one image source
  per plane, index 0 farthest) — data URIs for the self-contained
  export, or plain URLs a browser fetches each layer from."""
  return (_HTML_TEMPLATE
          .replace("__MPI_SOURCES__",
                   "[" + ",".join(f'"{u}"' for u in sources) + "]")
          .replace("__W__", str(w)).replace("__H__", str(h))
          .replace("__NEAR__", repr(float(near)))
          .replace("__FAR__", repr(float(far)))
          .replace("__FOV__", repr(float(fov_deg))))


def export_viewer_html(rgba_layers: np.ndarray, out_path: str,
                       near: float = 1.0, far: float = 100.0,
                       fov_deg: float = 60.0) -> str:
  """Write a self-contained HTML MPI viewer for ``[H, W, P, 4]`` layers.

  ``near``/``far`` must match the plane depths the MPI was built with
  (``inv_depths(near, far, P)``, index 0 farthest); ``fov_deg`` sets the
  CSS focal length. Returns ``out_path``.
  """
  rgba_layers = np.asarray(rgba_layers)
  h, w, p, _ = rgba_layers.shape
  uris = [to_data_uri(layer_to_png_bytes(rgba_layers[:, :, i]))
          for i in range(p)]
  html = render_viewer_html(uris, w, h, near=near, far=far,
                            fov_deg=fov_deg)
  with open(out_path, "w") as f:
    f.write(html)
  return out_path


def load_fixture_mpi(test_dir: str, prefix: str = "rgba_",
                     count: int | None = None) -> np.ndarray:
  """Load a baked PNG MPI (e.g. the reference's ``test/rgba_00..09.png``)
  into ``[H, W, P, 4]`` in [-1, 1] (alpha in (0, 1))."""
  from PIL import Image

  names = sorted(n for n in os.listdir(test_dir)
                 if n.startswith(prefix) and n.endswith(".png"))
  if count is not None:
    names = names[:count]
  layers = []
  for n in names:
    arr = np.asarray(
        Image.open(os.path.join(test_dir, n)).convert("RGBA"),
        np.float32) / 255.0
    layers.append(np.concatenate([arr[..., :3] * 2.0 - 1.0, arr[..., 3:]], -1))
  return np.stack(layers, axis=2)
