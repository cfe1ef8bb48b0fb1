"""Non-maximum suppression (counterpart of bigdl_tpu/nn/nms.py; ref
nn/Nms.scala, the helper beside RoiPooling on the detection path).

Greedy NMS keeps a box unless a kept box of higher score (earlier in the
descending, stable score order) overlaps it by an IoU above the
threshold.  The JAX package walks the order one box at a time
(``lax.fori_loop``, N steps).  Here the keep flags are the fixed point of
that rule taken all at once: start from every box kept, and set each
box's flag to "no kept box before it overlaps it", over the whole (N, N)
overlap matrix at each pass.  A box's flag is final one pass after every
flag before it is, so the passes end (at most N; a chain of suppressions
as long as the longest one in the data), and the rule's fixed point is
unique, so it is the greedy answer.  Each pass is one masked reduction
on the device; a pass that changes nothing ends the loop.
"""
from __future__ import annotations

import torch


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(N, 4) [x1, y1, x2, y2] boxes, inclusive pixel bounds -> (N, N)
    IoU."""
    x1, y1, x2, y2 = boxes.unbind(1)
    area = (torch.clamp_min(x2 - x1 + 1, 0)
            * torch.clamp_min(y2 - y1 + 1, 0))
    iw = torch.clamp_min(torch.minimum(x2[:, None], x2[None])
                         - torch.maximum(x1[:, None], x1[None]) + 1, 0)
    ih = torch.clamp_min(torch.minimum(y2[:, None], y2[None])
                         - torch.maximum(y1[:, None], y1[None]) + 1, 0)
    inter = iw * ih
    return inter / torch.clamp_min(area[:, None] + area[None] - inter, 1e-9)


def nms_mask(boxes, scores, threshold: float) -> torch.Tensor:
    """The (N,) bool keep mask of greedy NMS, on the boxes' device."""
    boxes = torch.as_tensor(boxes)
    scores = torch.as_tensor(scores, device=boxes.device)
    n = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    over = _iou_matrix(boxes)[order][:, order] > threshold
    # over[j, i]: box j comes before box i and overlaps it
    over &= torch.ones(n, n, dtype=torch.bool,
                       device=boxes.device).triu(diagonal=1)
    keep = torch.ones(n, dtype=torch.bool, device=boxes.device)
    for _ in range(n):
        new = ~(over & keep[:, None]).any(0)
        if torch.equal(new, keep):
            break
        keep = new
    mask = torch.empty_like(keep)
    mask[order] = keep
    return mask


def nms_indices(boxes, scores, threshold: float) -> torch.Tensor:
    """The kept boxes' indices, by descending score (Nms.scala's API)."""
    scores = torch.as_tensor(scores)
    idx = nms_mask(boxes, scores, threshold).nonzero()[:, 0]
    return idx[torch.argsort(-scores.to(idx.device)[idx], stable=True)]


class Nms:
    """Greedy NMS at one threshold, called on each proposal set (ref
    nn/Nms.scala)."""

    def __init__(self, threshold: float = 0.7):
        self.threshold = threshold

    def __call__(self, boxes, scores):
        return nms_indices(boxes, scores, self.threshold)

    def keep_mask(self, boxes, scores):
        return nms_mask(boxes, scores, self.threshold)
