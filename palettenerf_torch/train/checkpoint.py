"""Checkpoints: the port's own format, and loading the JAX package's pickles.

The port saves with ``torch.save`` (tensors, ints, floats, strings; no ``ml_dtypes``)
and keeps the JAX package's file naming and rolling policy
(``palettenerf_tpu/train/checkpoint.py``): ``<name>_ep<epoch>.ckpt`` keeping the
newest ``max_keep``, and ``<name>.ckpt`` for the best (EMA) weights.

``params_from_jax`` (stage-1 NeRF) and ``palette_params_from_jax`` (PaletteNeRF) turn
the JAX package's parameter tree (numpy arrays; MLPs as lists of ``{"w": [in, out]}``
layers, ``"b"`` where the layer has a bias) into the port's parameter dict.
``load_reference_checkpoint`` reads the JAX package's pickles without JAX and without
``ml_dtypes``: their hash tables are ``ml_dtypes`` bfloat16 arrays, which it reads as
``numpy.uint16`` arrays of the same 16-bit words. ``_leaf_to_tensor`` views such words
as ``torch.bfloat16``, bit for bit (the JAX package writes no uint16 leaves of its own).
``save_reference_checkpoint`` writes a parameter dict back in that layout (f32 leaves);
a trained palette state written so (``basis_color_origin`` and ``hist_weights``
included) is what ``main_serve`` and the JAX package's loader read.
``merge_params_non_strict`` is the NeRF -> Palette warm start by parameter name.
"""

from __future__ import annotations

import glob
import os
import pickle
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch


def _leaf_to_tensor(a, dtype=torch.float32) -> torch.Tensor:
    """A checkpoint leaf -> tensor. bf16 words (``uint16`` from ``load_reference_checkpoint``,
    or an ``ml_dtypes`` bfloat16 array) become ``torch.bfloat16`` bit for bit."""
    a = np.asarray(a)
    if a.dtype.name in ("bfloat16", "uint16"):
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(dtype) if dtype is not None else t


def _mlp_from_jax(layers, bias: bool = False) -> list:
    """A JAX MLP subtree -> list of layers: ``[in, out]`` tensors, or ``{"w", "b"}`` dicts
    of tensors for layers with a bias (only where ``bias`` allows them). Accepts the list
    of layer dicts and the numpy object array such a list was saved as
    (``deploy/proc_toys/palette_ep0080.ckpt``), unpacking it layer by layer."""
    out = []
    for layer in list(np.asarray(layers, dtype=object).reshape(-1)):
        if not isinstance(layer, dict) or "w" not in layer:
            raise ValueError(f"MLP layer is not a {{'w': array}} dict: {type(layer)}")
        if "b" not in layer:
            out.append(_leaf_to_tensor(layer["w"]))
        elif bias:
            out.append({"w": _leaf_to_tensor(layer["w"]), "b": _leaf_to_tensor(layer["b"])})
        else:
            raise ValueError("MLP layer has a bias; this network's MLPs are bias-free")
    return out


def _layers_to(layers: list, device) -> list:
    return [{k: v.to(device) for k, v in w.items()} if isinstance(w, dict) else w.to(device)
            for w in layers]


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """JAX NeRF parameter tree -> the port's parameter dict (f32 tensors on ``device``).

    Reads ``encoder``, ``sigma_net`` and ``color_net``, and the background net
    (``encoder_bg``, ``bg_net``) when present; other entries (palette heads, extra
    encoders) are ignored. Raises KeyError when one of the three is missing.
    """
    out = {
        "encoder": _leaf_to_tensor(tree["encoder"]).to(device),
        "sigma_net": [w.to(device) for w in _mlp_from_jax(tree["sigma_net"])],
        "color_net": [w.to(device) for w in _mlp_from_jax(tree["color_net"])],
    }
    out.update(_background_from_jax(tree, device))
    return out


def _background_from_jax(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """``encoder_bg`` and ``bg_net`` of a JAX tree that has a background net, else {}."""
    if "encoder_bg" not in tree:
        return {}
    return {"encoder_bg": _leaf_to_tensor(tree["encoder_bg"]).to(device),
            "bg_net": _layers_to(_mlp_from_jax(tree["bg_net"]), device)}


_PALETTE_MLPS = ("sigma_net", "color_net", "diff_net", "basis_net", "omega_net")


def palette_params_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """JAX PaletteNeRF parameter tree -> the port's parameter dict (f32 tensors on ``device``).

    Reads the three hash tables (``encoder_clip`` and ``clip_net`` only when present),
    the bias-free MLPs, ``offsets_radiance_net`` (one layer with a bias), the palette
    ``basis_color`` / ``basis_color_origin`` and, when present, ``hist_weights`` and the
    background net (``encoder_bg``, ``bg_net``).
    Raises KeyError when a required entry is missing.
    """
    out: Dict[str, Any] = {
        "encoder": _leaf_to_tensor(tree["encoder"]).to(device),
        "encoder_palette": _leaf_to_tensor(tree["encoder_palette"]).to(device),
        "offsets_radiance_net": _layers_to(_mlp_from_jax(tree["offsets_radiance_net"],
                                                         bias=True), device),
        "basis_color": _leaf_to_tensor(tree["basis_color"]).to(device),
        "basis_color_origin": _leaf_to_tensor(tree["basis_color_origin"]).to(device),
    }
    for name in _PALETTE_MLPS:
        out[name] = _layers_to(_mlp_from_jax(tree[name]), device)
    for name in ("encoder_clip", "hist_weights"):
        if name in tree:
            out[name] = _leaf_to_tensor(tree[name]).to(device)
    if "clip_net" in tree:
        out["clip_net"] = _layers_to(_mlp_from_jax(tree["clip_net"]), device)
    out.update(_background_from_jax(tree, device))
    return out


class _ReferenceUnpickler(pickle.Unpickler):
    """Reads ``ml_dtypes.bfloat16`` as ``numpy.uint16``: the array bytes are the same
    16-bit words, so no ``ml_dtypes`` is needed. Any other ``ml_dtypes`` type raises."""

    def find_class(self, module, name):
        if module == "ml_dtypes" or module.startswith("ml_dtypes."):
            if name == "bfloat16":
                return np.uint16
            raise pickle.UnpicklingError(
                f"checkpoint leaf of type ml_dtypes.{name}: only bfloat16 leaves are read "
                f"(as their 16-bit words)")
        return super().find_class(module, name)


def load_reference_checkpoint(path: str) -> Dict[str, Any]:
    """Unpickle a checkpoint written by the JAX package (numpy pytrees). bf16 leaves
    come back as ``uint16`` arrays of their words (see ``_leaf_to_tensor``)."""
    with open(path, "rb") as f:
        return _ReferenceUnpickler(f).load()


def load_palette_checkpoint(path: str, device="cpu"):
    """A trained palette checkpoint, whichever package wrote it -> (the port's parameter
    dict on ``device``, the grid-state dict or None). A ``torch.save`` file is the port's
    own (``PaletteTrainer.save_checkpoint``); anything else is read as a JAX-package
    pickle."""
    if zipfile.is_zipfile(path):
        payload = load_checkpoint(path)
        params = {k: _layers_to(v, device) if isinstance(v, list) else v.to(device)
                  for k, v in payload["params"].items()}
        gs = payload.get("grid_state")
        return params, gs and {k: v.numpy() for k, v in gs.items()}
    payload = load_reference_checkpoint(path)
    return palette_params_from_jax(payload["params"], device=device), payload.get("grid_state")


def save_reference_checkpoint(path: str, params: Dict[str, Any], epoch: int = 0,
                              global_step: int = 0,
                              grid_state: Optional[Dict[str, torch.Tensor]] = None) -> str:
    """Write the port's parameter dict as a pickle in the JAX package's layout
    (``palettenerf_tpu/train/checkpoint.py:save_checkpoint``): f32 numpy leaves, MLPs as
    lists of ``{"w"[, "b"]}`` layers, and ``grid_state`` as a dict of numpy arrays. The
    JAX package's loader and ``load_reference_checkpoint`` both read it."""
    def leaf(t):
        return t.detach().cpu().float().numpy() if t.is_floating_point() else t.cpu().numpy()

    def layer(w):
        return {k: leaf(v) for k, v in w.items()} if isinstance(w, dict) else {"w": leaf(w)}

    payload = {"epoch": epoch, "global_step": global_step,
               "params": {k: [layer(w) for w in v] if isinstance(v, list) else leaf(v)
                          for k, v in params.items()}}
    if grid_state is not None:
        payload["grid_state"] = {k: leaf(v) if torch.is_tensor(v) else v
                                 for k, v in grid_state.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return path


def merge_params_non_strict(target, source) -> tuple:
    """Copy source leaves into target wherever the (path, shape) matches.

    The counterpart of torch's ``load_state_dict(strict=False)``, used for the NeRF ->
    Palette warm start (``palettenerf_tpu/train/checkpoint.py:71-106``): the sigma and
    color nets, and the background net where both models have one. Trees are dicts
    and lists of tensors (or numpy arrays, which become f32 tensors); a merged leaf is a
    copy on the target leaf's device. Returns (merged, missing_paths, loaded_paths).
    """
    loaded, missing = [], []

    def walk(t, s, path):
        if isinstance(t, dict):
            out = {}
            for k, v in t.items():
                if isinstance(s, dict) and k in s:
                    out[k] = walk(v, s[k], path + (k,))
                else:
                    missing.append("/".join(map(str, path + (k,))))
                    out[k] = v
            return out
        if isinstance(t, (list, tuple)):
            out = []
            for i, v in enumerate(t):
                if isinstance(s, (list, tuple)) and i < len(s):
                    out.append(walk(v, s[i], path + (i,)))
                else:
                    missing.append("/".join(map(str, path + (i,))))
                    out.append(v)
            return type(t)(out) if isinstance(t, tuple) else out
        if s is not None and tuple(getattr(s, "shape", (None,))) == tuple(t.shape):
            loaded.append("/".join(map(str, path)))
            src = s if torch.is_tensor(s) else _leaf_to_tensor(s)
            return src.detach().to(device=t.device, dtype=t.dtype, copy=True)
        missing.append("/".join(map(str, path)))
        return t

    merged = walk(target, source, ())
    return merged, missing, loaded


def save_checkpoint(ckpt_dir: str, name: str, epoch: int, payload: Dict[str, Any],
                    max_keep: int = 2, best: bool = False) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{name}.ckpt" if best else f"{name}_ep{epoch:04d}.ckpt")
    torch.save(payload, path)
    if not best:
        for old in sorted(glob.glob(os.path.join(ckpt_dir, f"{name}_ep*.ckpt")))[:-max_keep]:
            os.remove(old)
    return path


def latest_checkpoint(ckpt_dir: str, name: str) -> Optional[str]:
    paths = sorted(glob.glob(os.path.join(ckpt_dir, f"{name}_ep*.ckpt")))
    return paths[-1] if paths else None


def load_checkpoint(path: str, device="cpu") -> Dict[str, Any]:
    return torch.load(path, map_location=device, weights_only=True)
