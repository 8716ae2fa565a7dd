"""The paper's own workload: a small 3-layer CNN classifier (MNIST-class).

The port of ``repro.models.cnn``, in PyTorch's NCHW idiom: three 3x3
convolutions with SAME padding and ReLU (``F.conv2d``; cuDNN on the
card), 2x2 VALID max-pools after the first two (28 -> 14 -> 7), and an fc
layer over the 7*7*32 features.  Params are a dict tree of tensors:
convolution weights in PyTorch's OIHW layout (the reference keeps HWIO;
``weights.cnn_from_jax`` carries them across), the fc weight in the
reference's ``(d_in, d_out)`` layout over features flattened in the
reference's NHWC order, so the activations are permuted to NHWC before
the flatten.  Trained on ``data.pipeline.SyntheticImages``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import random as R
from repro_torch import resolve_device

#: floor under the summed example weights of the weighted loss: a step
#: whose every worker was cut (all weights 0) gives loss 0, not 0/0
WEIGHT_FLOOR = 1e-6


def cnn_init(seed: int = 0, n_classes: int = 10, device=None):
    """Seeded params with the reference's draws: ``cnn_init(PRNGKey(seed))``
    through the ``jax.random`` twin, drawn on the CPU and moved to
    ``device`` (``None``: the card)."""
    device = resolve_device(device)
    ks = R.split(R.PRNGKey(seed), 4)

    def conv(k, cin, cout):
        w = R.normal(k, (3, 3, cin, cout)) * (1.0 / math.sqrt(9 * cin))
        return {"w": w.permute(3, 2, 0, 1).contiguous(),   # HWIO -> OIHW
                "b": torch.zeros(cout)}

    params = {"c1": conv(ks[0], 1, 16), "c2": conv(ks[1], 16, 32),
              "c3": conv(ks[2], 32, 32),
              "fc": {"w": R.normal(ks[3], (7 * 7 * 32, n_classes))
                     * (1.0 / math.sqrt(7 * 7 * 32)),
                     "b": torch.zeros(n_classes)}}
    return {k: {n: t.to(device) for n, t in p.items()}
            for k, p in params.items()}


def _conv(x, p):
    return torch.relu(F.conv2d(x, p["w"], p["b"], padding=1))


def cnn_apply(params, x):
    """x: (B, 28, 28) -> logits (B, n_classes)."""
    h = _conv(x[:, None], params["c1"])
    h = F.max_pool2d(h, 2)                                   # 14x14
    h = _conv(h, params["c2"])
    h = F.max_pool2d(h, 2)                                   # 7x7
    h = _conv(h, params["c3"])
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)        # NHWC order
    return h @ params["fc"]["w"] + params["fc"]["b"]


def cnn_loss(params, x, y, weights=None):
    """Cross-entropy of ``cnn_apply(params, x)``; see ``cross_entropy``."""
    return cross_entropy(cnn_apply(params, x), y, weights)


def cross_entropy(logits, y, weights=None):
    """The mean cross-entropy, or with per-example ``weights`` (the
    cutoff mask) ``sum(w * ce) / max(sum(w), WEIGHT_FLOOR)``."""
    ce = (torch.logsumexp(logits, dim=-1)
          - torch.gather(logits, 1, y.long()[:, None])[:, 0])
    if weights is None:
        return torch.mean(ce)
    w = weights.float()
    return torch.sum(w * ce) / torch.clamp(torch.sum(w), min=WEIGHT_FLOOR)
