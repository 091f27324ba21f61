"""VisualizationDemo: prompted single-image inference with overlay rendering
(counterpart of ``demo/predictor_lazy.py``), without PIL.

``VisualizationDemo`` wraps the port's ``DefaultPredictor``; ``draw`` renders
JAX's overlay with ``utils.draw``: a width-3 box and a label in the class
colour per instance above the confidence threshold, each instance's mask
pasted into its box (``_paste_mask``: PIL's bilinear resize, ``pil_resize``)
and composited at alpha 120, and the argmax of ``sem_seg`` resized by
nearest neighbour and composited at alpha 80. The image equals JAX's bit for
bit except the label text (``utils.draw.draw_label``).

``grabcut_refine`` and ``run_on_video`` need OpenCV (``cv2``), imported when
they run, and raise ``ImportError`` naming it where it is missing (JAX's
``grabcut_refine`` returns the mask unrefined instead); with ``cv2`` they
make JAX's calls. ``AsyncPredictor`` pipelines requests through a worker
thread and a bounded queue.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ape_tpu_torch.data.transforms import pil_resize, resize_nearest
from ape_tpu_torch.utils.draw import alpha_composite, draw_label, draw_rectangle, palette


def _host(x):
    """A tensor as a NumPy array on the host (float32 for floating dtypes)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    return np.asarray(x)


def _cv2(what: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} needs OpenCV (the cv2 module), which is not installed") from e
    return cv2


class VisualizationDemo:
    def __init__(self, ape_model, image_size: int = 1024, confidence_threshold: float = 0.3):
        from ape_tpu_torch.engine.defaults import DefaultPredictor

        self.predictor = DefaultPredictor(ape_model, image_size)
        self.threshold = confidence_threshold
        self.last_seconds: Dict[str, float] = {}

    def run_on_image(self, image: np.ndarray, text_prompt: Optional[str] = None,
                     with_box: bool = True, with_mask: bool = True, with_sseg: bool = False,
                     grabcut: bool = False):
        """image: RGB uint8 (H, W, 3). Returns (prediction, overlay); the
        seconds of the request's device part and of its drawing are left in
        ``last_seconds``."""
        t0 = time.perf_counter()
        pred = self.predictor(image, text_prompt=text_prompt)
        device = self.predictor.model.device
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        vis = self.draw(image, pred, with_box=with_box, with_mask=with_mask,
                        with_sseg=with_sseg, grabcut=grabcut)
        self.last_seconds = {"device": t1 - t0, "draw": time.perf_counter() - t1}
        return pred, vis

    def draw(self, image, pred: Dict, with_box=True, with_mask=True, with_sseg=False,
             grabcut=False) -> np.ndarray:
        h0, w0 = image.shape[:2]
        img = np.concatenate([image, np.full((h0, w0, 1), 255, np.uint8)], axis=2)
        overlay = np.zeros((h0, w0, 4), np.uint8)
        names = pred.get("text_list", [])
        colors = palette(max(len(names), 1))
        inst = pred.get("instances")
        if inst is not None:
            scores = _host(inst["scores"])
            keep = scores >= self.threshold
            boxes = _host(inst["boxes"])[keep]
            scores = scores[keep]
            classes = _host(inst["classes"])[keep]
            masks = inst.get("mask_logits")
            masks = _host(masks)[keep] if masks is not None else None
            for i in range(len(scores)):
                c = colors[int(classes[i]) % len(colors)]
                x0, y0, x1, y1 = [float(v) for v in boxes[i]]
                if with_box:
                    draw_rectangle(overlay, (x0, y0, x1, y1), c + (255,), width=3)
                label = (f"{names[int(classes[i])] if int(classes[i]) < len(names) else classes[i]}"
                         f" {scores[i]:.2f}")
                draw_label(overlay, (x0 + 2, max(y0 - 12, 0)), label, c + (255,))
                if with_mask and masks is not None:
                    m = _paste_mask(masks[i], (x0, y0, x1, y1), h0, w0)
                    if grabcut:
                        m = grabcut_refine(image, m)
                    # composited over the mask's rows and columns only:
                    # elsewhere its alpha is 0, which keeps the overlay
                    ys, xs = np.nonzero(m.any(1))[0], np.nonzero(m.any(0))[0]
                    if len(ys):
                        box = np.s_[ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1]
                        color_img = np.empty(m[box].shape + (4,), np.uint8)
                        color_img[..., :3] = c
                        color_img[..., 3] = (m[box] * 120).astype(np.uint8)
                        overlay[box] = alpha_composite(overlay[box], color_img)
        if with_sseg and "sem_seg" in pred:
            sem = _host(pred["sem_seg"]).argmax(0)
            sem_arr = resize_nearest(sem.astype(np.uint8), h0, w0)
            color_arr = np.zeros((h0, w0, 4), np.uint8)
            for cls in np.unique(sem_arr):
                color_arr[sem_arr == cls, :3] = colors[int(cls) % len(colors)]
                color_arr[sem_arr == cls, 3] = 80
            overlay = alpha_composite(overlay, color_arr)
        return np.ascontiguousarray(alpha_composite(img, overlay)[..., :3])


def _paste_mask(mask_logits: np.ndarray, box, h: int, w: int) -> np.ndarray:
    """A mask-feature-resolution logit map pasted into the full image: the
    sigmoid to uint8, PIL's bilinear resize to (h, w), then > 127 inside the
    box rounded to pixels and clipped to the image (JAX resizes the whole
    map; the port resizes the box's pixels, which are the same)."""
    prob = 1.0 / (1.0 + np.exp(-mask_logits))
    m = np.zeros((h, w), np.float32)
    x0, y0, x1, y1 = [int(round(v)) for v in box]
    x0, y0 = max(x0, 0), max(y0, 0)
    x1, y1 = min(x1, w), min(y1, h)
    # JAX's m[y0:y1, x0:x1]: a negative end counts from the far edge, as
    # Python slices do; only those pixels are resized (each its own taps)
    rows, cols = slice(*slice(y0, y1).indices(h)[:2]), slice(*slice(x0, x1).indices(w)[:2])
    if rows.stop > rows.start and cols.stop > cols.start:
        inside = pil_resize((prob * 255).astype(np.uint8), h, w, rows, cols)
        m[rows, cols] = (inside > 127).astype(np.float32)
    return m


def grabcut_refine(image: np.ndarray, mask: np.ndarray, iters: int = 3) -> np.ndarray:
    """GrabCut mask refinement seeded by the predicted mask (sure foreground
    by erosion, probable bands by dilation), as JAX's; a mask under 16
    pixels, or one OpenCV's grabCut refuses, comes back as given. Raises
    ImportError without OpenCV."""
    cv2 = _cv2("--grabcut (grabcut_refine)")
    m = np.full(mask.shape, cv2.GC_BGD, np.uint8)
    mask_u8 = (mask > 0.5).astype(np.uint8)
    if mask_u8.sum() < 16:
        return mask
    kernel = np.ones((5, 5), np.uint8)
    sure_fg = cv2.erode(mask_u8, kernel, iterations=2)
    prob_fg = mask_u8
    prob_bg = cv2.dilate(mask_u8, kernel, iterations=3)
    m[prob_bg > 0] = cv2.GC_PR_BGD
    m[prob_fg > 0] = cv2.GC_PR_FGD
    m[sure_fg > 0] = cv2.GC_FGD
    bgd = np.zeros((1, 65), np.float64)
    fgd = np.zeros((1, 65), np.float64)
    try:
        cv2.grabCut(image[:, :, ::-1].copy(), m, None, bgd, fgd, iters, cv2.GC_INIT_WITH_MASK)
    except cv2.error:
        return mask
    return ((m == cv2.GC_FGD) | (m == cv2.GC_PR_FGD)).astype(np.float32)


class AsyncPredictor:
    """Pipelined requests for video streams: a worker thread takes
    (index, image, kwargs) from a bounded queue and puts (index, result) on
    the results queue; a request's exception reaches the consumer."""

    def __init__(self, demo: "VisualizationDemo", buffer_size: int = 3):
        import queue
        import threading

        self.demo = demo
        self._tasks = queue.Queue(maxsize=buffer_size)
        self._results = queue.Queue()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        while True:
            item = self._tasks.get()
            if item is None:
                break
            idx, image, kwargs = item
            try:
                self._results.put((idx, self.demo.run_on_image(image, **kwargs)))
            except Exception as e:  # handed to the consumer, which raises it
                self._results.put((idx, e))

    def put(self, idx, image, **kwargs):
        self._tasks.put((idx, image, kwargs))

    def get(self):
        idx, res = self._results.get()
        if isinstance(res, Exception):
            raise res
        return idx, res

    def shutdown(self):
        self._tasks.put(None)


def run_on_video(demo: "VisualizationDemo", video_path, text_prompt=None, with_box=True,
                 with_mask=True, max_frames=None):
    """Frames of a video file or webcam index through ``AsyncPredictor``:
    yields (frame index, overlay). Raises ImportError without OpenCV."""
    cv2 = _cv2("--video-input and --webcam (run_on_video)")
    cap = cv2.VideoCapture(video_path)
    ap = AsyncPredictor(demo)
    n_in = 0
    n_out = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok or (max_frames and n_in >= max_frames):
                break
            rgb = frame[:, :, ::-1].copy()
            ap.put(n_in, rgb, text_prompt=text_prompt, with_box=with_box, with_mask=with_mask)
            n_in += 1
            while ap._results.qsize() > 0:  # drain ready results to bound memory
                idx, (pred, vis) = ap.get()
                n_out += 1
                yield idx, vis
        while n_out < n_in:
            idx, (pred, vis) = ap.get()
            n_out += 1
            yield idx, vis
    finally:
        ap.shutdown()
        cap.release()
