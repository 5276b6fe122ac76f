"""The comparison that decides ``correct``: each number beside its limit.

A configuration states its guarantee (``guarantee.distance``) and the limit
of every number compared (``limits``):

* ``dist_rel_gap`` (``"distance": "f32"``): the largest gap between a served
  distance and the reference's, over ``max(d_ref, 1)``.
* ``dist_rel_excess`` (a quantized slab, ``"distance": "bf16"`` or
  ``"f16"``): the same gap less twice the largest round-trip error of a
  label distance stored in that type, which the reference works out from
  its own corner-to-corner distances (an answer adds two stored label
  distances); 0 when every answer keeps to the slab's stated error.
* ``path_len_rel_gap`` (paths): the largest gap between the length of a
  served polyline and the reference's distance, over ``max(d_ref, 1)``.
* ``paths_invalid`` (paths): polylines that do not run from s to t, or
  that have a leg entering an obstacle by more than :data:`PATH_EROSION`.
* ``missing`` (open loop): requests never answered.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import Arith, blocked

#: a served leg may graze an obstacle by this much in map units (float32
#: visibility of the device path): deeper is a path through the obstacle
PATH_EROSION = 1e-4

_DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16}


def distance_gap(kind: str, ref, d: np.ndarray, d_ref: np.ndarray) -> tuple:
    """(check name, value) of served distances ``d`` against ``d_ref``."""
    d = np.asarray(d, np.float64)
    if not len(d):                      # nothing answered: nothing holds
        return ("dist_rel_gap" if kind == "f32" else "dist_rel_excess",
                float("inf"))
    scale = np.maximum(d_ref, 1.0)
    gap = np.where(np.isfinite(d), np.abs(d - d_ref), np.inf)
    if kind == "f32":
        return "dist_rel_gap", float(np.max(gap / scale, initial=0.0))
    q = ref.label_qerr(_DTYPES[kind])
    return "dist_rel_excess", float(
        np.max(np.maximum(gap - 2 * q, 0.0) / scale, initial=0.0))


def path_gaps(ref, s, t, paths, d_ref) -> dict:
    """{path_len_rel_gap, paths_invalid} of served polylines."""
    ar = Arith("f64")
    legs_p, legs_q, owner, lengths = [], [], [], np.zeros(len(paths))
    bad = np.zeros(len(paths), bool)
    for i, p in enumerate(paths):
        p = np.asarray(p, np.float64).reshape(-1, 2)
        if len(p) < 2 or not (np.array_equal(p[0], np.float64(s[i])) and
                              np.array_equal(p[-1], np.float64(t[i]))):
            bad[i] = True
            lengths[i] = np.inf
            continue
        legs_p.append(p[:-1])
        legs_q.append(p[1:])
        owner.append(np.full(len(p) - 1, i))
        lengths[i] = np.sqrt(((p[1:] - p[:-1]) ** 2).sum(1)).sum()
    if legs_p:
        dev = ref.device
        hit = blocked(ar.tensor(np.concatenate(legs_p), dev),
                      ar.tensor(np.concatenate(legs_q), dev),
                      ar.tensor(ref.rects64, dev), ar,
                      erode=PATH_EROSION).cpu().numpy()
        bad[np.concatenate(owner)[hit]] = True
    gap = np.abs(lengths - d_ref) / np.maximum(d_ref, 1.0)
    return {"path_len_rel_gap": float(np.max(gap, initial=0.0)),
            "paths_invalid": float(bad.sum())}


def compare(cfg: dict, ref, s, t, d, paths=None, missing=None) -> list:
    """[(name, value, limit)] of one run's sample.  ``paths``: [((s, t),
    polylines)] of requests whose polylines were kept; ``missing``: the
    requests an open loop never got an answer to."""
    limits = cfg["limits"]
    d_ref = ref.solve(s, t)
    name, v = distance_gap(cfg["guarantee"]["distance"], ref, d, d_ref)
    out = [(name, v, limits[name])]
    if paths is not None and not paths:      # no polyline was kept
        out += [(k, float("inf"), limits[k])
                for k in ("path_len_rel_gap", "paths_invalid")]
    elif paths is not None:
        ps = np.concatenate([st[0] for st, _ in paths])
        pt = np.concatenate([st[1] for st, _ in paths])
        polys = [p for _, pl in paths for p in pl]
        got = path_gaps(ref, ps, pt, polys, ref.solve(ps, pt))
        out += [(k, v, limits[k]) for k, v in got.items()]
    if missing is not None:
        out.append(("missing", float(missing), limits["missing"]))
    return out
