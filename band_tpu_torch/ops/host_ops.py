"""Host-side (non-jittable) implementations of TFLite custom ops.

The reference handles ops its delegates cannot run by falling back to
CPU interpreters (band/model_analyzer.cc:627-789 partitions around
them).  Here, custom ops run as numpy functions on a host worker; the
analyzer routes the containing unit-subgraph to a host (CPU) worker.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

HOST_OPS: Dict[str, Callable] = {}


def register_host_op(name: str):
    def deco(fn):
        HOST_OPS[name] = fn
        return fn

    return deco


def has_host_impl(opname: str) -> bool:
    return opname in HOST_OPS


def run_host_op(opname: str, graph, op, inputs: List[np.ndarray]):
    return HOST_OPS[opname](graph, op, inputs)


def _decode_center_size(boxes_enc, anchors, opts):
    """tensorflow/lite/kernels/detection_postprocess.cc DecodeCenterSizeBoxes."""
    scale_y = opts.get("y_scale", 10.0)
    scale_x = opts.get("x_scale", 10.0)
    scale_h = opts.get("h_scale", 5.0)
    scale_w = opts.get("w_scale", 5.0)
    ya, xa, ha, wa = anchors.T
    ty, tx, th, tw = boxes_enc.T
    ycenter = ty / scale_y * ha + ya
    xcenter = tx / scale_x * wa + xa
    half_h = 0.5 * np.exp(th / scale_h) * ha
    half_w = 0.5 * np.exp(tw / scale_w) * wa
    return np.stack(
        [ycenter - half_h, xcenter - half_w, ycenter + half_h, xcenter + half_w],
        axis=1,
    )


def _single_class_nms(decoded, scores, candidate_idx, iou_thr, max_sel):
    """Greedy NMS over pre-thresholded candidates, highest score first
    (kernel: NonMaxSuppressionSingleClassHelper; suppression is
    iou > threshold, so equality survives)."""

    def iou(box, rest):
        yx1 = np.maximum(box[:2], rest[:, :2])
        yx2 = np.minimum(box[2:], rest[:, 2:])
        inter = np.prod(np.clip(yx2 - yx1, 0, None), axis=1)
        a1 = np.prod(box[2:] - box[:2])
        a2 = np.prod(rest[:, 2:] - rest[:, :2], axis=1)
        denom = a1 + a2 - inter
        return np.where(denom > 0, inter / np.maximum(denom, 1e-30), 0.0)

    idx = candidate_idx[np.argsort(-scores[candidate_idx], kind="stable")]
    keep = []
    while idx.size and len(keep) < max_sel:
        i = idx[0]
        keep.append(int(i))
        if idx.size == 1:
            break
        rest = idx[1:]
        idx = rest[iou(decoded[i], decoded[rest]) <= iou_thr]
    return keep


@register_host_op("CUSTOM:TFLite_Detection_PostProcess")
def _detection_postprocess(graph, op, inputs: List[np.ndarray]):
    """SSD detection post-processing: center-size box decode + NMS.

    Mirrors tflite::ops::custom::detection_postprocess (the kernel the
    reference's TFLite backend runs for SSD heads) with options from
    the op's flexbuffer map: the fast path (class-max NMS over anchors,
    use_regular_nms=false — what shipped SSD models use) and the
    regular path (per-class NMS capped at detections_per_class, global
    top-max_detections merge).  Validated against the real kernel in
    tests/test_ssd_detection.py.
    """
    boxes_enc, scores, anchors = inputs[0], inputs[1], inputs[2]
    opts = op.options
    max_det = int(opts.get("max_detections", 10))
    mcpd = max(int(opts.get("max_classes_per_detection", 1)), 1)
    det_per_class = int(opts.get("detections_per_class", 100))
    use_regular = bool(opts.get("use_regular_nms", False))
    iou_thr = float(opts.get("nms_iou_threshold", 0.5))
    score_thr = float(opts.get("nms_score_threshold", 0.0))

    boxes_enc = boxes_enc.reshape(-1, 4).astype(np.float32)
    anchors = anchors.reshape(-1, 4).astype(np.float32)
    scores = scores.reshape(boxes_enc.shape[0], -1).astype(np.float32)
    num_with_bg = scores.shape[1]
    num_classes = int(opts.get("num_classes", num_with_bg))
    label_offset = num_with_bg - num_classes  # 1 when background col present
    cls_scores = scores[:, label_offset:]

    decoded = _decode_center_size(boxes_enc, anchors, opts)

    # output row count is max_detections * max_classes_per_detection on
    # both paths (kernel Prepare: num_detected_boxes)
    num_rows = max_det * mcpd
    out_boxes = np.zeros((1, num_rows, 4), np.float32)
    out_classes = np.zeros((1, num_rows), np.float32)
    out_scores = np.zeros((1, num_rows), np.float32)

    if use_regular:
        pooled = []  # (score, class, box_index)
        for c in range(num_classes):
            s = cls_scores[:, c]
            cand = np.flatnonzero(s > score_thr)
            for i in _single_class_nms(decoded, s, cand, iou_thr,
                                       min(det_per_class, max_det)):
                pooled.append((float(s[i]), c, i))
        pooled.sort(key=lambda t: -t[0])
        pooled = pooled[:max_det]
        for j, (sc, c, i) in enumerate(pooled):
            out_boxes[0, j] = decoded[i]
            out_classes[0, j] = c
            out_scores[0, j] = sc
        n = len(pooled)
    else:
        anchor_max = cls_scores.max(axis=1) if num_classes else cls_scores[:, 0]
        cand = np.flatnonzero(anchor_max > score_thr)
        selected = _single_class_nms(decoded, anchor_max, cand, iou_thr, max_det)
        k = min(mcpd, num_classes)
        row = 0
        for i in selected:
            top = np.argsort(-cls_scores[i], kind="stable")[:k]
            for col, c in enumerate(top):
                slot = mcpd * row + col
                out_boxes[0, slot] = decoded[i]
                out_classes[0, slot] = c
                out_scores[0, slot] = cls_scores[i, c]
            row += 1
        n = row * k
    return [out_boxes, out_classes, out_scores,
            np.asarray([n], np.float32)]
