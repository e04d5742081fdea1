"""Detection and training visualization (the port's own copy of
``partsbaseddetector_tpu/utils/viz.py``: the drawing functions and the
training views — HOG glyphs, model montages, part-cluster montages and
the skeleton).

Python equivalent of the reference's Visualize component
(reference: src/Visualize.cpp:54-129): an HSV color ramp over parts,
rectangle overlays per part, confidence text for the root.  Renders with
PIL (no OpenCV dependency), imported inside the functions so that the
module loads without it; returns/writes RGB uint8 arrays.
"""

from __future__ import annotations

import colorsys
from typing import List, Optional, Sequence

import numpy as np


def part_colors(nparts: int) -> List[tuple]:
    """HSV ramp over parts (reference: src/Visualize.cpp:60-72)."""
    out = []
    for p in range(nparts):
        h = p / max(nparts, 1)
        r, g, b = colorsys.hsv_to_rgb(h, 1.0, 1.0)
        out.append((int(r * 255), int(g * 255), int(b * 255)))
    return out


def draw_detections(image: np.ndarray, detections: Sequence,
                    max_candidates: Optional[int] = None,
                    with_score: bool = True) -> np.ndarray:
    """Overlay part boxes for each detection
    (reference: src/Visualize.cpp:74-117).

    image: (H, W[, 3]) uint8/float; detections: list of Detection.
    Returns an RGB uint8 copy."""
    from PIL import Image, ImageDraw

    img = np.asarray(image)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    pil = Image.fromarray(img)
    draw = ImageDraw.Draw(pil)
    H, W = img.shape[:2]

    dets = list(detections)
    if max_candidates is not None:
        dets = dets[:max_candidates]
    for det in dets:
        det = det.own()
        colors = part_colors(len(det.parts))
        for p, box in enumerate(det.parts):
            x1, y1, x2, y2 = (float(v) for v in box)
            x1, x2 = np.clip([x1, x2], 0, W - 1)
            y1, y2 = np.clip([y1, y2], 0, H - 1)
            if x2 <= x1 or y2 <= y1:
                continue
            draw.rectangle([x1, y1, x2, y2], outline=colors[p], width=1)
        if with_score:
            bx = det.parts[0]
            draw.text((float(np.clip(bx[0], 0, W - 40)),
                       float(np.clip(bx[1] - 12, 0, H - 12))),
                      f"{det.score:.2f}", fill=(255, 255, 255))
    return np.asarray(pil)


def save_image(path: str, image: np.ndarray) -> None:
    from PIL import Image
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    Image.fromarray(img).save(path)


def draw_skeleton(image: np.ndarray, detections: Sequence,
                  parents: Sequence[int], width: int = 4) -> np.ndarray:
    """Stick-figure rendering: a line from each part's box center to its
    parent's, colored per part (the Matlab skeleton renderer,
    reference: matlab/visualization/showskeletons.m:1-20)."""
    from PIL import Image, ImageDraw

    img = np.asarray(image)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    pil = Image.fromarray(img)
    draw = ImageDraw.Draw(pil)
    for det in detections:
        det = det.own()
        P = len(det.parts)
        colors = part_colors(P)
        cx = (det.parts[:, 0] + det.parts[:, 2]) / 2.0
        cy = (det.parts[:, 1] + det.parts[:, 3]) / 2.0
        for child in range(1, P):
            par = int(parents[child])
            draw.line([(float(cx[par]), float(cy[par])),
                       (float(cx[child]), float(cy[child]))],
                      fill=colors[child], width=width)
    return np.asarray(pil)


def fold_hog(w: np.ndarray, norient: int = 18) -> np.ndarray:
    """Condense a HOG filter into a norient/2-orientation positive
    histogram (reference: matlab/visualization/foldHOG.m:1-7): the two
    contrast-sensitive halves and the insensitive block, clamped at 0 and
    summed."""
    w = np.asarray(w, np.float64)
    h = norient // 2
    return (np.maximum(w[:, :, 0:h], 0)
            + np.maximum(w[:, :, h:2 * h], 0)
            + np.maximum(w[:, :, 2 * h:3 * h], 0))


def hog_picture(w9: np.ndarray, bs: int = 20) -> np.ndarray:
    """Render an n-orientation weight grid as oriented-edge glyphs
    (reference: matlab/visualization/HOGpicture.m:1-28): one bs x bs bar
    glyph per orientation, rotated in 180/n-degree steps, added with the
    (non-negative) weights.  Returns float (bs*H, bs*W)."""
    from PIL import Image

    n = w9.shape[2]
    base = np.zeros((bs, bs), np.float64)
    mid = int(round(bs / 2.0)) - 1
    base[:, mid:mid + 2] = 1.0
    glyphs = [base]
    im0 = Image.fromarray((base * 255).astype(np.uint8))
    for i in range(1, n):
        rot = im0.rotate(-180.0 / n * i, resample=Image.BILINEAR,
                         expand=False)
        glyphs.append(np.asarray(rot, np.float64) / 255.0)

    w = np.maximum(np.asarray(w9, np.float64), 0)
    H, W = w.shape[:2]
    out = np.zeros((bs * H, bs * W), np.float64)
    for i in range(H):
        for j in range(W):
            cell = sum(glyphs[k] * w[i, j, k] for k in range(n))
            out[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = cell
    return out


def visualize_filter(filt: np.ndarray, bs: int = 20,
                     norient: int = 18) -> np.ndarray:
    """uint8 glyph rendering of one part filter (foldHOG + HOGpicture +
    the gray border, reference: matlab/visualization/visualizemodel.m:
    30-43)."""
    w9 = fold_hog(filt, norient)
    scale = max(float(np.abs(w9).max()), 1e-12)
    p = hog_picture(w9, bs)
    p = np.pad(p, 2)
    p = np.clip(p * (255.0 / scale), 0, 255).astype(np.uint8)
    p[:, :4] = 128
    p[:, -4:] = 128
    p[:4, :] = 128
    p[-4:, :] = 128
    return p


def visualize_model(model, bs: int = 20, mixture: int = 0) -> np.ndarray:
    """Montage of one component's part filters pasted at their anchor
    offsets (reference: matlab/visualization/visualizemodel.m:45-92).
    Returns a uint8 grayscale image."""
    comp = model.components[0]
    P = comp.nparts
    tiles = []
    for p in range(P):
        part = comp.parts[p]
        m = min(mixture, len(part.filterid) - 1)
        tiles.append(visualize_filter(
            np.asarray(model.filters[part.filterid[m]]), bs,
            model.norient))

    im = tiles[0]
    start = np.zeros((P, 2), np.int64)   # top-left of each pasted tile
    for p in range(1, P):
        part = comp.parts[p]
        m = min(mixture, len(part.defid) - 1)
        ax, ay = (int(v) for v in np.asarray(
            model.anchors[part.defid[m]])[:2])
        par = int(part.parentid)
        x1 = ax * bs + start[par, 0]
        y1 = ay * bs + start[par, 1]
        grow_x = max(0, -x1)
        grow_y = max(0, -y1)
        if grow_x or grow_y:
            new = np.zeros((im.shape[0] + grow_y,
                            im.shape[1] + grow_x), im.dtype)
            new[grow_y:, grow_x:] = im
            im = new
            start += np.array([grow_x, grow_y])
            x1 += grow_x
            y1 += grow_y
        t = tiles[p]
        y2, x2 = y1 + t.shape[0], x1 + t.shape[1]
        if y2 > im.shape[0] or x2 > im.shape[1]:
            new = np.zeros((max(im.shape[0], y2),
                            max(im.shape[1], x2)), im.dtype)
            new[:im.shape[0], :im.shape[1]] = im
            im = new
        im[y1:y2, x1:x2] = t
        start[p] = (x1, y1)
    return im


def _crop_pad(image: np.ndarray, y1: int, y2: int, x1: int, x2: int
              ) -> np.ndarray:
    """Inclusive crop with zero padding outside the image (the
    reference's subarray(im, y1, y2, x1, x2, 0),
    matlab/visualization/showpartclusters.m:26)."""
    H, W = image.shape[:2]
    ch = y2 - y1 + 1
    cw = x2 - x1 + 1
    if image.ndim == 2:
        image = image[:, :, None]
    out = np.zeros((ch, cw, image.shape[2]), image.dtype)
    sy1, sy2 = max(y1, 0), min(y2, H - 1)
    sx1, sx2 = max(x1, 0), min(x2, W - 1)
    if sy1 <= sy2 and sx1 <= sx2:
        out[sy1 - y1:sy2 - y1 + 1, sx1 - x1:sx2 - x1 + 1] = \
            image[sy1:sy2 + 1, sx1:sx2 + 1]
    return out


def _montage(patches: np.ndarray) -> np.ndarray:
    """Square-ish grid of (N, h, w, c) patches (Matlab montage)."""
    n, h, w, c = patches.shape
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    out = np.zeros((rows * h, cols * w, c), patches.dtype)
    for i in range(n):
        r, cc = divmod(i, cols)
        out[r * h:(r + 1) * h, cc * w:(cc + 1) * w] = patches[i]
    return out


def show_part_clusters(images: Sequence[np.ndarray],
                       boxes: np.ndarray,
                       idx: Sequence[np.ndarray],
                       patch_size: int = 40,
                       out_dir: Optional[str] = None):
    """Cluster-assignment debug view for training-time K selection —
    the counterpart of matlab/visualization/showpartclusters.m: for
    each (part p, mixture m), a montage of the positives' part patches
    assigned to that cluster, each patch cropped from the part's box
    (zero-padded outside the image) and resized to
    patch_size x patch_size.

    images: N positives; boxes: (N, P, 4) part boxes (point_to_box
    output); idx: per part, (N,) cluster assignment (cluster_parts
    output).  Returns {(part, mixture): uint8 montage}; when out_dir
    is set, also writes cluster/part{p}/mix{m}.png under it (the
    reference's [visualdir 'cluster/part%d/mix%d.jpg'] layout)."""
    from partsbaseddetector_tpu_torch.oracle.reference import resize_linear

    N = len(images)
    P = len(idx)
    patches = np.zeros((N, P, patch_size, patch_size, 3), np.uint8)
    for n in range(N):
        im = np.asarray(images[n])
        if im.ndim == 2:
            im = np.repeat(im[:, :, None], 3, axis=2)
        for p in range(P):
            x1, y1, x2, y2 = (int(round(float(v)))
                              for v in boxes[n, p])
            crop = _crop_pad(im, y1, y2, x1, x2).astype(np.float64)
            rs = resize_linear(crop, (patch_size, patch_size))
            patches[n, p] = np.clip(rs, 0, 255).astype(np.uint8)

    out = {}
    for p in range(P):
        assign = np.asarray(idx[p])
        for m in range(int(assign.max()) + 1):
            members = np.nonzero(assign == m)[0]
            if len(members) == 0:
                continue
            mont = _montage(patches[members, p])
            out[(p, m)] = mont
            if out_dir is not None:
                import os
                d = os.path.join(out_dir, "cluster", f"part{p}")
                os.makedirs(d, exist_ok=True)
                save_image(os.path.join(d, f"mix{m}.png"), mont)
    return out


def visualize_hog_weights(w: np.ndarray, bs: int = 20) -> np.ndarray:
    """Positive/negative HOG-weight panel — the counterpart of
    matlab/visualization/visualizeHOG.m: fold to 9 insensitive
    orientations, render +w and -w glyph pictures on a shared scale,
    pad each with a gray border and stack vertically (uint8)."""
    w9 = fold_hog(np.asarray(w, float))
    scale = max(float(np.max(w9)), float(np.max(-w9)), 1e-12)
    pos = hog_picture(np.maximum(w9, 0), bs) * 255.0 / scale
    neg = hog_picture(np.maximum(-w9, 0), bs) * 255.0 / scale
    buff = 10
    def pad(x):
        out = np.full((x.shape[0] + 2 * buff, x.shape[1] + 2 * buff),
                      128.0)
        out[buff:-buff, buff:-buff] = x
        return out
    return np.clip(np.concatenate([pad(pos), pad(neg)], axis=0),
                   0, 255).astype(np.uint8)


def visualize_skeleton(model, component: int = 0, cell: int = 24
                       ) -> np.ndarray:
    """Model-skeleton view — the counterpart of
    matlab/visualization/visualizeskeleton.m: the part tree drawn from
    each part's mean anchor offset (no image; edges parent -> child,
    parts colored with the part ramp).  Returns an RGB uint8 canvas."""
    from PIL import Image, ImageDraw

    comp = model.components[component]
    P = comp.nparts
    pos = np.zeros((P, 2))            # (x, y) in cell units
    for p in range(1, P):
        part = comp.parts[p]
        anchors = np.stack([
            np.asarray(model.anchors[d]).ravel()[:2].astype(float)
            for d in part.defid])
        pos[p] = pos[part.parentid] + anchors.mean(axis=0)
    pos -= pos.min(axis=0)
    size = (pos.max(axis=0) + 2) * cell / 4.0 + 20
    img = Image.new("RGB", (max(int(size[0]), 64),
                            max(int(size[1]), 64)), (255, 255, 255))
    draw = ImageDraw.Draw(img)
    pts = pos * cell / 4.0 + 10
    colors = part_colors(P)
    for p in range(1, P):
        q = comp.parts[p].parentid
        draw.line([tuple(pts[q]), tuple(pts[p])], fill=(80, 80, 80),
                  width=2)
    r = 4
    for p in range(P):
        x, y = pts[p]
        draw.ellipse([x - r, y - r, x + r, y + r], fill=colors[p])
    return np.asarray(img)
