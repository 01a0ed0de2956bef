"""OpenCV's mask-to-rectangle chain without OpenCV, host numpy: what
``cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)``, then
``max(contours, key=cv2.contourArea)``, ``cv2.minAreaRect`` and
``cv2.boxPoints`` give, for ``ops/bbox_transforms.py:mask2poly_single``
(the port does not depend on OpenCV).

* ``external_contours``: Suzuki and Abe's border following as OpenCV
  runs it (a zero frame around the mask, border pixels marked 2 or, where
  the scan examined their right neighbour, -126; an outer border started
  only outside every other, holes never followed), each border kept at
  its direction changes, the contours in OpenCV's list order (the last
  found first).
* ``contour_area``: the shoelace area, exact on integer points.
* ``convex_hull``: OpenCV's Sklansky hull of integer points (sorted by x
  then y, the four monotone chains, clockwise as ``minAreaRect`` asks,
  and the cyclic shift that makes the input indices ascending where it
  can).
* ``min_area_rect``: rotating calipers in f32 over the clockwise hull, as
  OpenCV's ``minAreaRect`` runs them (the last of equal areas kept, as
  its ``<=`` does), then the centre, the size and the angle in degrees in
  [-90, 0), as OpenCV 5 gives them; ``box_points``: the four corners in
  ``boxPoints``' order.

The contours and hulls equal OpenCV's; the rectangles' corners agree with
``cv2.boxPoints`` within 2e-5 px on seeded blob masks, about half of them
bit for bit (not every f32 step of OpenCV 5's calipers is reproduced).
Where two rectangles tie for the least area (a square blob, or a blob
with two equal minimal boxes), the rounding can keep another one of them
than OpenCV: then the two rectangles have the same area and both enclose
the contour.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

# chain codes: 0 east, then counter-clockwise on the screen (y down)
_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_DY = (0, -1, -1, -1, 0, 1, 1, 1)
_RIGHT_BOUND = -126          # OpenCV's (2 | -128) as a signed char
_F = np.float32


def _follow(img, y0: int, x0: int) -> List[Tuple[int, int]]:
    """Follow the outer border that starts at (y0, x0) of the framed
    image ``img`` (int8, marked in place); its direction-change points
    (x, y) in the frame's coordinates."""
    def at(y, x, s):
        return img[y + _DY[s], x + _DX[s]]

    s_end = s = 4
    while True:                       # the first neighbour, clockwise
        s = (s - 1) & 7
        if at(y0, x0, s) != 0 or s == s_end:
            break
    if s == s_end and at(y0, x0, s) == 0:          # a single pixel
        img[y0, x0] = _RIGHT_BOUND
        return [(x0, y0)]
    y1, x1 = y0 + _DY[s], x0 + _DX[s]
    y3, x3 = y0, x0
    prev_s = s ^ 4
    px, py = x0, y0
    pts = []
    while True:
        s_end = s
        s = min(s, 15)
        while s < 15:
            s += 1
            if at(y3, x3, s & 7) != 0:
                break
        s &= 7
        y4, x4 = y3 + _DY[s], x3 + _DX[s]
        if 1 <= s <= s_end:
            img[y3, x3] = _RIGHT_BOUND
        elif img[y3, x3] == 1:
            img[y3, x3] = 2
        if s != prev_s:
            pts.append((px, py))
            prev_s = s
        px += _DX[s]
        py += _DY[s]
        if (y4, x4) == (y0, x0) and (y3, x3) == (y1, x1):
            return pts
        y3, x3 = y4, x4
        s = (s + 4) & 7


def external_contours(mask) -> List[np.ndarray]:
    """The external contours of ``mask != 0`` as OpenCV finds them
    (``RETR_EXTERNAL``, ``CHAIN_APPROX_SIMPLE``): int32 [K, 2] (x, y)
    point arrays, the last found first."""
    m = np.asarray(mask) != 0
    h, w = m.shape
    img = np.zeros((h + 2, w + 2), np.int8)
    img[1:-1, 1:-1] = m
    found = []
    for y in range(1, h + 1):
        row = img[y]
        lnbd_x = 0
        prev = 0
        x = 1
        while x < w + 1:
            # the next change along the row, from x on
            diff = np.nonzero(row[x:w + 1] != prev)[0]
            if diff.size == 0:
                break
            x += int(diff[0])
            p = int(row[x])
            if prev == 0 and p == 1 and (lnbd_x == 0
                                         or img[y, lnbd_x] <= 0):
                pts = _follow(img, y, x)
                found.append(np.asarray(pts, np.int32) - 1)
                # the scan resumes past the start, from its mark, and
                # leaves the last border pixel where it was
                prev = int(row[x])
                x += 1
                continue
            prev = p
            if prev & -2:
                lnbd_x = x
            x += 1
    return found[::-1]


def contour_area(pts) -> float:
    """The shoelace area of a closed contour (OpenCV's ``contourArea``,
    unsigned)."""
    p = np.asarray(pts, np.int64)
    if p.shape[0] < 3:
        return 0.0
    q = np.roll(p, -1, 0)
    return abs(float((p[:, 0] * q[:, 1] - p[:, 1] * q[:, 0]).sum())) / 2.0


def _sign(v) -> int:
    return (v > 0) - (v < 0)


def _sklansky(pts, order, start: int, end: int, nsign: int, sign2: int):
    """OpenCV's ``Sklansky_`` over the sorted points ``pts[order]`` from
    ``start`` to ``end``: the chain's positions in ``order``."""
    def pt(k):
        return pts[order[k]]

    incr = 1 if end > start else -1
    pprev, pcur = start, start + incr
    pnext = pcur + incr
    if start == end or tuple(pt(start)) == tuple(pt(end)):
        return [start]
    stack = [pprev, pcur, pnext]
    end += incr
    while pnext != end:
        cury, nexty = pt(pcur)[1], pt(pnext)[1]
        by = nexty - cury
        if _sign(by) != nsign:
            ax = pt(pcur)[0] - pt(pprev)[0]
            bx = pt(pnext)[0] - pt(pcur)[0]
            ay = cury - pt(pprev)[1]
            convexity = ay * bx - ax * by
            if _sign(convexity) == sign2 and (ax != 0 or ay != 0):
                pprev, pcur = pcur, pnext
                pnext += incr
                stack.append(pnext)
            elif pprev == start:
                pcur = pnext
                stack[1] = pcur
                pnext += incr
                stack[2] = pnext
            else:
                stack[-2] = pnext
                pcur = pprev
                pprev = stack[-4]
                stack.pop()
        else:
            pnext += incr
            stack[-1] = pnext
    return stack[:-1]


def convex_hull(points) -> np.ndarray:
    """OpenCV's ``convexHull(points, clockwise=True)`` of int32 points
    [K, 2], as ``minAreaRect`` takes it: the hull's points [H, 2] in its
    order."""
    pts = [tuple(int(v) for v in p) for p in np.asarray(points)]
    total = len(pts)
    order = sorted(range(total), key=lambda i: pts[i])
    miny = maxy = 0
    for i in range(1, total):
        y = pts[order[i]][1]
        if pts[order[miny]][1] > y:
            miny = i
        if pts[order[maxy]][1] < y:
            maxy = i
    if pts[order[0]] == pts[order[-1]]:
        hull = [order[0]]
    else:
        tl = _sklansky(pts, order, 0, maxy, -1, 1)
        tr = _sklansky(pts, order, total - 1, maxy, -1, -1)
        hull = [order[k] for k in tl[:-1]]
        hull += [order[k] for k in tr[:0:-1]]
        stop = tr[1] if len(tr) > 2 else tl[-2] if len(tl) > 2 else -1
        # clockwise: OpenCV swaps the two lower chains
        bl = _sklansky(pts, order, total - 1, miny, 1, 1)
        br = _sklansky(pts, order, 0, miny, 1, -1)
        if stop >= 0:
            check = bl[1] if len(bl) > 2 else \
                br[2 - len(bl)] if len(bl) + len(br) > 2 else -1
            if check == stop or (check >= 0 and pts[order[check]]
                                 == pts[order[stop]]):
                # all points on one line: the lower chain mirrors the
                # upper one
                bl, br = bl[:2], br[:2]
        hull += [order[k] for k in bl[:-1]]
        hull += [order[k] for k in br[:0:-1]]
        hull = _ascending_shift(hull)
    return np.asarray([pts[i] for i in hull], np.int32).reshape(-1, 2)


def _ascending_shift(hull):
    """OpenCV's cyclic shift of the hull's input indices toward an
    ascending or descending run."""
    nout = len(hull)
    if nout < 3:
        return hull
    min_idx = max_idx = lt = 0
    for i in range(1, nout):
        idx = hull[i]
        lt += hull[i - 1] < idx
        if 1 < lt <= i - 2:
            break
        if idx < hull[min_idx]:
            min_idx = i
        if idx > hull[max_idx]:
            max_idx = i
    mmdist = abs(max_idx - min_idx)
    if (mmdist == 1 or mmdist == nout - 1) and (lt <= 1 or lt >= nout - 2):
        ascending = (max_idx + 1) % nout == min_idx
        i0 = min_idx if ascending else max_idx
        if i0 > 0:
            out, j = [], i0
            for i in range(nout):
                cur = hull[j]
                nj = j + 1 if j + 1 < nout else 0
                out.append(cur)
                if i < nout - 1 and ascending != (cur < hull[nj]):
                    return hull
                j = nj
            return out
    return hull


def _calipers(pts):
    """OpenCV's ``rotatingCalipers`` (min-area mode) over f32 hull points
    [n, 2], n > 2: the corner, and the two side vectors."""
    n = len(pts)
    x = [_F(p[0]) for p in pts]
    y = [_F(p[1]) for p in pts]
    vx, vy, inv = [], [], []
    left = bottom = right = top = 0
    left_x = right_x = x[0]
    top_y = bottom_y = y[0]
    x0, y0 = x[0], y[0]
    for i in range(n):
        if x0 < left_x:
            left_x, left = x0, i
        if x0 > right_x:
            right_x, right = x0, i
        if y0 > top_y:
            top_y, top = y0, i
        if y0 < bottom_y:
            bottom_y, bottom = y0, i
        j = i + 1 if i + 1 < n else 0
        dx = float(_F(x[j] - x0))
        dy = float(_F(y[j] - y0))
        vx.append(_F(dx))
        vy.append(_F(dy))
        inv.append(_F(1.0 / math.sqrt(dx * dx + dy * dy)))
        x0, y0 = x[j], y[j]
    orientation = _F(0)
    ax, ay = float(vx[-1]), float(vy[-1])
    for i in range(n):
        bx, by = float(vx[i]), float(vy[i])
        convexity = ax * by - ay * bx
        if convexity != 0:
            orientation = _F(1) if convexity > 0 else _F(-1)
            break
        ax, ay = bx, by
    if orientation == 0:
        raise ValueError("min_area_rect: a degenerate hull")
    base_a, base_b = orientation, _F(0)
    seq = [bottom, right, top, left]
    minarea = _F(np.finfo(np.float32).max)
    best = None
    for _ in range(n):
        dp = [base_a * vx[seq[0]] + base_b * vy[seq[0]],
              -base_b * vx[seq[1]] + base_a * vy[seq[1]],
              -base_a * vx[seq[2]] - base_b * vy[seq[2]],
              base_b * vx[seq[3]] - base_a * vy[seq[3]]]
        maxcos = dp[0] * inv[seq[0]]
        main = 0
        for i in range(1, 4):
            cosalpha = dp[i] * inv[seq[i]]
            if cosalpha > maxcos:
                main, maxcos = i, cosalpha
        k = seq[main]
        lead_x = vx[k] * inv[k]
        lead_y = vy[k] * inv[k]
        base_a, base_b = ((lead_x, lead_y), (lead_y, -lead_x),
                          (-lead_x, -lead_y), (-lead_y, lead_x))[main]
        seq[main] = 0 if seq[main] + 1 == n else seq[main] + 1
        dx = x[seq[1]] - x[seq[3]]
        dy = y[seq[1]] - y[seq[3]]
        width = dx * base_a + dy * base_b
        dx = x[seq[2]] - x[seq[0]]
        dy = y[seq[2]] - y[seq[0]]
        height = -dx * base_b + dy * base_a
        area = width * height
        if area <= minarea:
            minarea = area
            best = (seq[3], base_a, width, base_b, height, seq[0])
    lft, a1, width, b1, height, bot = best
    a2, b2 = -b1, a1
    c1 = a1 * x[lft] + y[lft] * b1
    c2 = a2 * x[bot] + y[bot] * b2
    idet = _F(1) / (a1 * b2 - a2 * b1)
    px = (c1 * b2 - c2 * b1) * idet
    py = (a1 * c2 - a2 * c1) * idet
    return (px, py), (a1 * width, b1 * width), (a2 * height, b2 * height)


def min_area_rect(points):
    """OpenCV's ``minAreaRect`` of int32 points [K, 2]: ((cx, cy), (w, h),
    angle in degrees), f32 values."""
    hull = convex_hull(points).astype(np.float32)
    n = len(hull)
    if n > 2:
        o0, o1, o2 = _calipers(hull)
        cx = o0[0] + (o1[0] + o2[0]) * _F(0.5)
        cy = o0[1] + (o1[1] + o2[1]) * _F(0.5)
        w = _F(math.sqrt(float(o1[0]) ** 2 + float(o1[1]) ** 2))
        h = _F(math.sqrt(float(o2[0]) ** 2 + float(o2[1]) ** 2))
        angle = _F(math.atan2(float(o1[1]), float(o1[0])))
    elif n == 2:
        cx = (hull[0, 0] + hull[1, 0]) * _F(0.5)
        cy = (hull[0, 1] + hull[1, 1]) * _F(0.5)
        dx = float(hull[1, 0]) - float(hull[0, 0])
        dy = float(hull[1, 1]) - float(hull[0, 1])
        w, h = _F(math.sqrt(dx * dx + dy * dy)), _F(0)
        angle = _F(math.atan2(dy, dx))
    else:
        cx, cy = (hull[0, 0], hull[0, 1]) if n else (_F(0), _F(0))
        w = h = angle = _F(0)
    angle = _F(float(angle * _F(180)) / math.pi)
    if angle >= 0:                     # into [-90, 0): -0.0 too
        w, h, angle = h, w, angle - _F(90)
    return (cx, cy), (w, h), angle


def box_points(rect) -> np.ndarray:
    """OpenCV's ``boxPoints``: the rectangle's corners [4, 2], f32."""
    (cx, cy), (w, h), angle = rect
    cx, cy, w, h = _F(cx), _F(cy), _F(w), _F(h)
    rad = float(angle) * math.pi / 180.0
    b = _F(math.cos(rad)) * _F(0.5)
    a = _F(math.sin(rad)) * _F(0.5)
    p0 = (cx - a * h - b * w, cy + b * h - a * w)
    p1 = (cx + a * h - b * w, cy - b * h - a * w)
    p2 = (_F(2) * cx - p0[0], _F(2) * cy - p0[1])
    p3 = (_F(2) * cx - p1[0], _F(2) * cy - p1[1])
    return np.asarray([p0, p1, p2, p3], np.float32)


def mask_min_area_rect_points(mask) -> np.ndarray:
    """The corners of the minimum-area rectangle of the mask's largest
    external contour (the first of the largest in OpenCV's list order),
    [4, 2] f32; zeros for an empty mask."""
    contours = external_contours(mask)
    if not contours:
        return np.zeros((4, 2), np.float32)
    contour = max(contours, key=contour_area)
    return box_points(min_area_rect(contour))
