"""Oracle CFAR: direct per-cell transcription of the reference's detectors."""

from __future__ import annotations

import numpy as np


def cfar1d_sub(
    datamatrix: np.ndarray,
    ref_cells: int,
    guard_cells: int,
    t_cfar: float,
    method: int,
) -> np.ndarray:
    """Function_CFAR1D_sub.m: per-column CFAR with edge fallback.

    ``datamatrix`` (rows, cols); detection runs along columns for every row.
    """
    rows, cols = datamatrix.shape
    out = np.zeros((rows, cols))
    g, r = guard_cells, ref_cells
    for y in range(cols):  # 0-based; MATLAB y is 1-based
        lo_l = y - (g + r)
        hi_l = y - g  # exclusive
        lo_r = y + g + 1
        hi_r = y + g + r + 1  # exclusive
        if lo_l >= 0:
            left = datamatrix[:, lo_l:hi_l].mean(axis=1)
        else:
            left = datamatrix[:, lo_r:hi_r].mean(axis=1)
        if hi_r <= cols:
            right = datamatrix[:, lo_r:hi_r].mean(axis=1)
        else:
            right = datamatrix[:, lo_l:hi_l].mean(axis=1)
        ref = np.maximum(left, right) if method == 0 else np.minimum(left, right)
        out[:, y] = (datamatrix[:, y] >= ref * t_cfar).astype(float)
    return out


def cfar1d_ref_levels(
    datamatrix: np.ndarray, ref_cells: int, guard_cells: int, method: int
) -> np.ndarray:
    """The reference level ``cfar1d_sub`` compares each cell against (before
    the threshold factor), with the same edge fallback; along columns."""
    rows, cols = datamatrix.shape
    out = np.zeros((rows, cols))
    g, r = guard_cells, ref_cells
    for y in range(cols):
        lo_l, hi_l = y - (g + r), y - g
        lo_r, hi_r = y + g + 1, y + g + r + 1
        left = (datamatrix[:, lo_l:hi_l] if lo_l >= 0
                else datamatrix[:, lo_r:hi_r]).mean(axis=1)
        right = (datamatrix[:, lo_r:hi_r] if hi_r <= cols
                 else datamatrix[:, lo_l:hi_l]).mean(axis=1)
        out[:, y] = np.maximum(left, right) if method == 0 else np.minimum(left, right)
    return out


def execute_cfar(
    rdm: np.ndarray,
    ref_r: int,
    save_r: int,
    t_r: float,
    method_r: int,
    ref_v: int,
    save_v: int,
    t_v: float,
    method_v: int,
    mtd_0_num: int,
    r_detect_flag: bool = True,
    range_cell_nums: int = 1,
):
    """executeCFAR.m: velocity-dim CFAR, then per-hit range-dim confirmation."""
    nv, nr = rdm.shape
    lo = mtd_0_num + 1           # MATLAB MTD_0_num+2, 0-based
    hi = nv - mtd_0_num          # exclusive
    used = rdm[lo:hi, :]
    nvu = used.shape[0]

    vflag_used = cfar1d_sub(used.T, ref_v, save_v, t_v, method_v).T
    vflags = np.zeros((nv, nr))
    vflags[lo:hi, :] = vflag_used

    if not r_detect_flag:
        return vflags.copy(), vflags

    cascade = np.zeros((nvu, nr))
    v_hits, r_hits = np.nonzero(vflag_used)
    # np.nonzero is row-major; MATLAB find() is column-major — order does not
    # affect the result because each hit is processed independently.
    for v, r in zip(v_hits, r_hits):
        cells = np.arange(r - range_cell_nums, r + range_cell_nums + 1)
        cells = cells[(cells >= 0) & (cells < nr)]
        row = used[v, :]
        det = np.zeros(nr)
        for y in cells:
            g, rr = save_r, ref_r
            lo_l, hi_l = y - (g + rr), y - g
            lo_r, hi_r = y + g + 1, y + g + rr + 1
            if lo_l >= 0:
                left = row[lo_l:hi_l].mean()
            else:
                left = row[lo_r:hi_r].mean()
            if hi_r <= nr:
                right = row[lo_r:hi_r].mean()
            else:
                right = row[lo_l:hi_l].mean()
            ref = max(left, right) if method_r == 0 else min(left, right)
            det[y] = float(row[y] >= ref * t_r)
        nz = np.nonzero(det)[0]
        if len(nz) > 0:
            best = nz[np.argmax(row[nz])]
            cascade[v, best] = 1.0

    flags = np.zeros((nv, nr))
    flags[lo:hi, :] = cascade
    return flags, vflags
