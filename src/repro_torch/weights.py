"""Carry a JAX parameter tree, as numpy arrays, into the port's parameters.

``from_jax(cfg, params_np)`` takes ``repro.models.model.init_model``'s tree
after ``jax.tree.map(np.asarray, params)`` and returns the dicts that
``repro_torch.models.model`` reads:

* ``params["segments"][i]`` holds a segment's layers; where the segment
  repeats, each leaf carries a leading ``repeats`` axis, which is unstacked
  here into one dict per layer, in the order the JAX scan runs them.
* Dense weights keep the JAX ``(d_in, d_out)`` layout (no transpose): the
  port applies them as ``x @ w`` too.
* A tied head reuses ``embed.table``; an untied one is ``lm_head.w``
  ``(d_model, vocab)``.  The qwen2 QKV biases ``bq/bk/bv`` come along with
  the rest of the attention dict.
* Nested dicts are carried whole: xlstm-350m's one segment of 8 pattern
  dicts (7 mLSTM + 1 sLSTM, each leaf stacked over 3 repeats) becomes 24
  layer dicts, the sLSTM cell as its own ``slstm`` dict (``w``, ``r``,
  ``bias``).
* Whisper's ``encoder.segments`` unstack into ``encoder.layers``; its
  ``encoder.final_norm``, ``encoder.pos_table`` and ``dec_pos_table``
  are carried as they are.

``state_from_jax`` carries a whole train state ``{"params", "opt"[,
"ef"]}``, ``runtime_model_from_jax`` a DMM ``RuntimeModel``'s params
(dicts and lists of arrays, carried whole) with its ``norm_scale``, and
``cnn_from_jax`` the paper's CNN (convolutions HWIO -> OIHW).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.runtime_model.api import RuntimeModel
from repro_torch.models.model import (build_segments, encoder_layer_specs,
                                      layer_specs)


def _tensor(a, device):
    if a.dtype.name == "bfloat16":   # an extension dtype torch cannot take
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))   # a writable copy
    return t.to(device)


def _tree(node, device, index=None):
    if isinstance(node, dict):
        return {k: _tree(v, device, index) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tree(v, device, index) for v in node]
    a = np.asarray(node)
    return _tensor(a if index is None else a[index], device)


def _layers(specs, segments_np, device):
    """A JAX ``segments`` list -> one dict a layer, in scan order."""
    layers = []
    for seg, sp in zip(build_segments(specs), segments_np):
        for r in range(seg.repeats):
            index = r if seg.repeats > 1 else None
            for pi in range(len(seg.pattern)):
                layers.append(_tree(sp[pi], device, index))
    return layers


def from_jax(cfg, params_np, device=None):
    """JAX parameter tree (numpy leaves) -> port parameters on ``device``,
    each in its array's own dtype.  Whisper's encoder segments unstack as
    the decoder's do, into ``encoder.layers``; its final norm, the encoder
    and decoder position tables come across whole."""
    device = resolve_device(device)
    params = {"embed": _tree(params_np["embed"], device),
              "layers": _layers(layer_specs(cfg), params_np["segments"],
                                device),
              "final_norm": _tree(params_np["final_norm"], device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = _tree(params_np["lm_head"], device)
    if cfg.is_encoder_decoder:
        enc = params_np["encoder"]
        params["encoder"] = {
            "layers": _layers(encoder_layer_specs(cfg), enc["segments"],
                              device),
            "final_norm": _tree(enc["final_norm"], device),
            "pos_table": _tree(enc["pos_table"], device)}
        params["dec_pos_table"] = _tree(params_np["dec_pos_table"], device)
    return params


def state_from_jax(cfg, state_np, device=None):
    """A JAX train state ``{"params", "opt"[, "ef"]}`` (numpy leaves) -> the
    port's.

    Every optimizer tree with the params' structure (Adam's ``m`` and ``v``,
    momentum's ``mu``) is carried like the params; ``step`` becomes a host
    int, as the port's optimizers keep it.  A compressed run's error-feedback
    residuals ``ef`` (params-shaped, f32) are carried the same way.
    """
    opt = {}
    for name, val in state_np["opt"].items():
        if name == "step":
            opt[name] = int(np.asarray(val))
        else:
            opt[name] = from_jax(cfg, val, device)
    out = {"params": from_jax(cfg, state_np["params"], device), "opt": opt}
    if "ef" in state_np:
        out["ef"] = from_jax(cfg, state_np["ef"], device)
    return out


def runtime_model_from_jax(params_np, norm_scale: float, *, lag: int = 20,
                           device=None):
    """A reference ``RuntimeModel``'s params (``jax.tree.map(np.asarray,
    rm.params)``) and ``norm_scale`` -> the port's ``RuntimeModel`` on
    ``device``; the widths are read off the params."""
    dmm = params_np["dmm"]
    z_dim, hidden = np.asarray(dmm["trans_h"][0]["w"]).shape
    n_workers = np.asarray(dmm["emit_std"][0]["w"]).shape[0]
    rm = RuntimeModel(n_workers, lag=lag, z_dim=z_dim, hidden=hidden,
                      norm_scale=float(norm_scale), device=device)
    rm.params = _tree(params_np, rm.device)
    return rm


def cnn_from_jax(params_np, device=None):
    """``repro.models.cnn.cnn_init``'s params (numpy leaves) -> the port's
    ``models.cnn`` params on ``device``: each convolution weight from HWIO
    to OIHW; the fc weight keeps its (7*7*32, classes) layout, since the
    port flattens its features in the reference's NHWC order."""
    device = resolve_device(device)
    out = {}
    for name, p in params_np.items():
        w = np.asarray(p["w"])
        if w.ndim == 4:
            w = np.ascontiguousarray(w.transpose(3, 2, 0, 1))
        out[name] = {"w": _tensor(w, device),
                     "b": _tensor(np.asarray(p["b"]), device)}
    return out
