"""Checkpoint -> servable MPI scenes (the train -> serve bridge).

PyTorch counterpart of ``mpi_vision_tpu/ckpt/export.py``. ``serve --ckpt
<dir>`` restores a trained checkpoint, runs the stereo-magnification
forward pass over dataset examples on the serving device, assembles each
prediction into an RGBA MPI (``mpi_from_net_output``) and hands the results
to ``RenderService`` as scenes: what ``--mpi-dir`` does for baked PNG
stacks, fed by training output instead of files.

The model is rebuilt from the manifest's ``model`` block (written by
``train --ckpt``: num_planes / img_size / norm / compute_dtype), so the
serving side needs no out-of-band config. Only the params are restored:
a one-scalar peek reads the step and the manifest, then the restore loads
and hash-verifies exactly the model's arrays (``restore(template=...)``),
so Adam's moments, about two thirds of the payload, are never read.

Two layouts are read: the port's own (``['model']['cnv1_1.conv.weight']``,
``train/loop.py:checkpoint_tree``) and the JAX package's
(``['params']['cnv1_1']['conv']['kernel']``), whose flax params are carried
across with ``state_dict_from_jax_params``. Scene ids embed the checkpoint
step and a digest of the params' manifest entries, taken over whichever
prefix holds them, so a JAX-written checkpoint gets the JAX package's ids
letter for letter, and a cache shared across model versions never serves
a stale bake.
"""

from __future__ import annotations

import hashlib
import os
from typing import Mapping

import numpy as np
import torch

from mpi_vision_tpu_torch.ckpt.store import CheckpointStore

# Where each layout keeps the U-Net's arrays.
PORT_PREFIX = "['model']"
JAX_PREFIX = "['params']"
# The port's state-dict leaf -> the flax param path under each block.
_JAX_LEAVES = {"conv.weight": ("conv", "kernel"), "conv.bias": ("conv", "bias"),
               "norm.weight": ("norm", "scale"), "norm.bias": ("norm", "bias")}


def _manifest_params_digest(manifest: Mapping, prefix: str) -> str:
  """A stable content digest of the checkpoint's params (scene-id
  versioning) from the manifest's per-array sha256 entries under
  ``prefix`` — the bytes were already hashed and verified on restore; no
  second pass."""
  h = hashlib.sha256()
  for key, entry in sorted(manifest["arrays"].items()):
    if key.startswith(prefix):
      h.update(key.encode())
      h.update(entry["sha256"].encode())
  return h.hexdigest()


def _params_template(names, prefix: str) -> dict:
  """The restore template of the model's arrays in one layout."""
  if prefix == PORT_PREFIX:
    return {"model": dict.fromkeys(names)}
  tree: dict = {}
  for name in names:
    block, leaf = name.split(".", 1)
    group, key = _JAX_LEAVES[leaf]
    tree.setdefault(block, {}).setdefault(group, {})[key] = None
  return {"params": tree}


def restore_params(ckpt_dir: str, log=None, device=None):
  """Restore the newest good checkpoint's network.

  Returns ``(model, model_meta, step)``: ``model`` is the rebuilt
  ``StereoMagnificationModel`` on ``device`` (default the card; raises
  without one unless ``"cpu"``) with the restored weights, in eval mode;
  ``model_meta`` is the manifest's ``model`` block, the reference defaults
  (``config.TrainConfig``) for missing keys, plus ``params_digest``. The
  model is built on the meta device first (shapes, no init), so a
  480 px / 33-plane restore pays no throwaway initialisation.

  A typo'd ``ckpt_dir`` raises ``FileNotFoundError`` without creating it.
  A checkpoint whose params fail verification is quarantined, and the
  next newest one is tried.
  """
  from mpi_vision_tpu_torch.ckpt.store import CorruptCheckpointError
  from mpi_vision_tpu_torch.config import dtype_of
  from mpi_vision_tpu_torch.device import resolve_device
  from mpi_vision_tpu_torch.models.stereo_mag import (
      StereoMagnificationModel,
      state_dict_from_jax_params,
  )

  if not os.path.isdir(ckpt_dir):
    # CheckpointStore.__init__ creates its root (right for a writer); on
    # this read-only path that would turn a typo'd --ckpt into an empty
    # store and a confusing "no restorable checkpoint".
    raise FileNotFoundError(f"checkpoint directory does not exist: {ckpt_dir}")
  device = resolve_device(device)
  store = CheckpointStore(ckpt_dir)
  say = log if log is not None else (lambda _m: None)
  on_q = lambda s, r: say(f"ckpt: quarantined step {s} ({r}); falling back")
  while True:
    # Two passes keep the restore params-only: the model meta needed to
    # build the template lives in the manifest, so peek it through the
    # one step scalar (its dtype is each layout's own, int32 in the JAX
    # package's and int64 in the port's; a template's leaves carry no
    # dtype), then restore exactly the params. A checkpoint whose params
    # turn out corrupt is quarantined and the peek repeats.
    peek = store.restore(template={"step": None}, on_quarantine=on_q)
    if peek is None:
      raise FileNotFoundError(f"no restorable checkpoint under {ckpt_dir}")
    model_block = dict(peek.meta.get("model", {}))
    num_planes = int(model_block.get("num_planes", 10))
    img_size = int(model_block.get("img_size", 224))
    norm = model_block.get("norm", "instance")
    compute_dtype = model_block.get("compute_dtype")
    with torch.device("meta"):
      model = StereoMagnificationModel(num_planes=num_planes, norm=norm,
                                       dtype=dtype_of(compute_dtype))
    names = list(model.state_dict())
    prefix = (PORT_PREFIX if any(k.startswith(PORT_PREFIX)
                                 for k in peek.manifest["arrays"])
              else JAX_PREFIX)
    template = _params_template(names, prefix)
    try:
      restored = store.restore(step=peek.step, template=template)
    except CorruptCheckpointError as e:
      on_q(peek.step, e.reason)
      continue
    break
  tree = restored.tree(template)
  state = ({k: torch.from_numpy(np.asarray(v)) for k, v in
            tree["model"].items()} if prefix == PORT_PREFIX
           else state_dict_from_jax_params(tree["params"], norm))
  model.to_empty(device=device)
  model.load_state_dict(state)
  model.eval()
  meta = {"num_planes": num_planes, "img_size": img_size, "norm": norm,
          "compute_dtype": compute_dtype,
          "depth_near": float(model_block.get("depth_near", 1.0)),
          "depth_far": float(model_block.get("depth_far", 100.0)),
          "params_digest": _manifest_params_digest(restored.manifest,
                                                   prefix)}
  return model, meta, restored.step


def scenes_from_checkpoint(ckpt_dir: str, dataset_path: str | None = None,
                           scenes: int = 2, prefix: str = "ckpt",
                           stable_ids: bool = False, log=None,
                           device=None) -> tuple[list[tuple], dict]:
  """Render-ready scenes from a checkpoint's forward pass.

  Args:
    ckpt_dir: a ``CheckpointStore`` root (as written by ``train --ckpt``,
      of either package).
    dataset_path: RealEstate10K-layout root providing the reference
      images and PSVs the network consumes; None synthesizes a small
      procedural dataset at the checkpoint's image size in a temporary
      directory, removed afterwards (hermetic mode).
    scenes: examples (= scenes) to bake, drawn from the test split's
      fixed triplets (same checkpoint -> same scenes).
    prefix: scene-id prefix.
    stable_ids: scene ids are ``{prefix}_{i:03d}`` instead of embedding
      the step and params digest. Live reload (``--reload-ckpt-s``) needs
      this: the new step's scenes swap in under the ids clients already
      hold (``RenderService.swap_scenes``).
    log: optional diagnostics sink.
    device: where the dataset builds its PSVs and the forward pass runs
      (default the card; raises without one unless ``"cpu"``).

  Returns:
    ``(scene_list, info)``: each scene is ``(scene_id, rgba_layers [H, W,
    P, 4], depths [P], intrinsics [3, 3])``, host float32 arrays ready for
    ``RenderService.add_scene``; ``info`` holds the step, the params
    digest and the model meta.
  """
  from mpi_vision_tpu_torch.core.camera import inv_depths
  from mpi_vision_tpu_torch.data import realestate
  from mpi_vision_tpu_torch.models.stereo_mag import mpi_from_net_output

  say = log if log is not None else (lambda _m: None)
  model, meta, ckpt_step = restore_params(ckpt_dir, log=log, device=device)
  device = next(model.parameters()).device
  digest = meta["params_digest"]

  tmp_holder = None
  try:
    if dataset_path is None:
      import tempfile

      tmp_holder = tempfile.TemporaryDirectory(prefix="mpi_ckpt_scenes_")
      realestate.synthesize_dataset(
          tmp_holder.name, num_scenes=max(scenes, 1), frames=4,
          img_size=meta["img_size"], seed=0)
      dataset_path = tmp_holder.name
      say(f"serve: synthesized {scenes} ckpt scene source(s) at "
          f"{dataset_path}")
    dataset = realestate.RealEstateDataset(
        dataset_path, is_valid=True, img_size=meta["img_size"],
        num_planes=meta["num_planes"], device=device)
    if not len(dataset):
      raise ValueError(
          f"dataset at {dataset_path} has an empty test split; nothing to "
          "bake from the checkpoint")

    depths = inv_depths(meta["depth_near"], meta["depth_far"],
                        meta["num_planes"]).numpy()
    out = []
    for i in range(min(scenes, len(dataset))):
      example = dataset[i]
      with torch.no_grad():
        pred = model(example["net_input"][None])
        rgba = mpi_from_net_output(pred, example["ref_img"][None])
      scene_id = (f"{prefix}_{i:03d}" if stable_ids
                  else f"{prefix}_{ckpt_step}_{digest[:8]}_{i:03d}")
      out.append((scene_id, rgba[0].cpu().numpy(), depths,
                  example["intrinsics"].cpu().numpy()))
      say(f"serve: baked {scene_id} from checkpoint step {ckpt_step}")
  finally:
    if tmp_holder is not None:
      # The scene arrays are on the host now; the synthesized PNG dataset
      # has no further readers.
      tmp_holder.cleanup()
  info = {"step": ckpt_step, "params_digest": digest, **meta}
  return out, info
