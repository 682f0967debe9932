"""Training visualization: gt, pseudo and predicted boxes drawn on images
(PyTorch port of ubteacher_tpu.utils.visualizer).

Equivalent of the reference's visualize_training
(ubteacher/modeling/one_stage_detector.py:242-321), on the host: annotated
PNGs under OUTPUT_DIR/vis every VIS_PERIOD iterations. Drawing and writing
need cv2, imported at the call.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

_COLORS = [
    (66, 133, 244), (219, 68, 55), (244, 180, 0), (15, 157, 88),
    (171, 71, 188), (0, 172, 193), (255, 112, 67), (158, 157, 36),
]


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("training visualization (VIS_PERIOD > 0) needs cv2 (opencv-python); "
                          "set VIS_PERIOD 0 where it is absent") from e
    return cv2


def draw_boxes(
    image_bgr: np.ndarray,  # (H, W, 3) float or uint8, BGR
    boxes: np.ndarray,  # (N, 4) xyxy
    classes: Optional[Sequence[int]] = None,
    scores: Optional[Sequence[float]] = None,
    mask: Optional[np.ndarray] = None,
    thickness: int = 1,
) -> np.ndarray:
    cv2 = _cv2()
    img = np.ascontiguousarray(np.clip(image_bgr, 0, 255).astype(np.uint8))
    for i in range(len(boxes)):
        if mask is not None and not mask[i]:
            continue
        x1, y1, x2, y2 = (int(round(float(v))) for v in boxes[i])
        cls = int(classes[i]) if classes is not None else 0
        color = _COLORS[cls % len(_COLORS)]
        cv2.rectangle(img, (x1, y1), (x2, y2), color, thickness)
        label = str(cls)
        if scores is not None:
            label += f":{float(scores[i]):.2f}"
        cv2.putText(img, label, (x1, max(y1 - 3, 10)), cv2.FONT_HERSHEY_SIMPLEX, 0.4, color, 1)
    return img


def save_training_panels(output_dir: str, iteration: int, name: str, panels: Sequence[dict]) -> str:
    """Side-by-side panels like the reference's visualize_training
    (one_stage_detector.py:242-321: labeled = gt | predictions; unlabeled =
    pseudo-cls | pseudo-reg | predictions).

    Each panel dict: {"title", "image" (H, W, 3) BGR, "boxes" (N, 4) xyxy,
    optional "mask", "classes", "scores"}. Returns the written path."""
    cv2 = _cv2()
    vis_dir = os.path.join(output_dir, "vis")
    os.makedirs(vis_dir, exist_ok=True)
    imgs = []
    for p in panels:
        img = draw_boxes(p["image"], p["boxes"], classes=p.get("classes"), scores=p.get("scores"),
                         mask=p.get("mask"), thickness=2)
        cv2.putText(img, p.get("title", ""), (4, 14), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1)
        imgs.append(img)
    path = os.path.join(vis_dir, f"iter_{iteration:07d}_{name}.png")
    cv2.imwrite(path, np.concatenate(imgs, axis=1))
    return path
