"""The commensurate moments field behind ``k_align`` / ``k_coh``: the
counterpart of ``ops/grid_moments.py`` of the JAX package, whose module doc
derives the algebra.

In short: the fine grid is the hashgrid's (``g_fine`` cells, a multiple of
16), the alignment (CIC) grid has ``g_align = g_fine / Q`` cells for an even
ratio ``Q``, so every fine cell lies inside one corner block and the four
bilinear corner weights of an agent are affine in its fine-cell-local
coordinates ``(x~, y~)``.  The deposit is then one 16-channel per-fine-cell
sum of monomials, a dense einsum against a constant ``[Q, Q, 2, 2, 16, 5]``
table and four rolls; the sample is a dense einsum into a per-fine-cell
table of polynomial coefficients, one gather an agent and a polynomial.

The port's differences:

- The per-cell sums take a fixed order on every device: the rows sorted by
  cell (a stable sort, or the shared plan's own sort), then a segmented
  scan read at each cell's last row (:func:`sorted_cell_sums`).  JAX's
  ``.at[key].add`` would be ``index_add_``, whose CUDA form adds with
  atomics in an order that changes from run to run, so two runs of one
  rollout would drift apart.  The sums equal JAX's up to the order of the
  additions.
- The einsums run in full f32 on the card (TF32 off,
  ``_numerics.einsum``).
- The constant tables live on the device once per geometry
  (:func:`block_tables`); a tick captured in a CUDA graph must find them
  there, and the card's BLAS handle made (:func:`prepare`, through
  ``physics.prepare_tick``), since neither a copy from the host nor a
  handle's creation can be captured.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from ._numerics import div, einsum, mod
from .neighbors import torus_cell_xy

N_MOMENTS = 16
N_CHANNELS = 5          # vx, vy, relx, rely, cnt: the CIC layout
N_COEFFS = 4            # polynomial monomials {1, x~, y~, x~y~}

Keys = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def align_cell_arg(align_cell: float) -> Optional[float]:
    """A config's ``align_cell`` as this module's argument: any value <= 0
    means "derive the canonical cell" (``None``: ``cell_a = 4 *
    cell_sep``)."""
    return float(align_cell) if align_cell > 0 else None


def commensurate_geometry(
    torus_hw: float,
    sep_cell: float,
    align_cell: Optional[float] = None,
) -> Tuple[int, float, int, float, int]:
    """(g_fine, cell_fine, g_align, cell_align, ratio) of the commensurate
    pair of grids tiling ``[-hw, hw)^2``.  ``g_fine`` follows the hashgrid
    kernel's rounding (a multiple of 16); ``align_cell=None`` derives
    ``cell_a = 4 * cell_sep``; an explicit value must resolve to an even
    integer number of fine cells an alignment cell, or this raises."""
    g = (int(2.0 * torus_hw / sep_cell) // 16) * 16
    if g < 16:
        raise ValueError(
            f"torus [-{torus_hw}, {torus_hw}) tiled by sep cell "
            f"{sep_cell} gives fewer than 16 aligned fine cells; the "
            "commensurate moments field needs the hash-grid geometry"
        )
    cell_fine = 2.0 * torus_hw / g
    if align_cell is None:
        ga = g // 4
    else:
        ga = int(round(2.0 * torus_hw / align_cell))
        if ga < 2 or g % ga != 0 or (g // ga) % 2 != 0:
            raise ValueError(
                f"align_cell={align_cell} is not commensurate with "
                f"the separation grid: the alignment cell must be an "
                f"EVEN integer multiple of the effective sep cell "
                f"(canonically cell_a = 4*cell_sep = "
                f"{4.0 * cell_fine}); got {ga} alignment cells "
                f"against {g} fine cells (ratio "
                f"{g / ga if ga else float('inf'):.3g})"
            )
    q = g // ga
    if q % 2 != 0 or q < 2 or ga < 2:
        raise ValueError(
            f"commensurate ratio must be an even integer >= 2 with "
            f">= 2 alignment cells (cell_a = 4*cell_sep is the "
            f"canonical choice); got g_fine={g}, g_align={ga}"
        )
    return g, cell_fine, ga, 2.0 * torus_hw / ga, q


@lru_cache(maxsize=None)
def _block_tensors(q: int, cell_fine: float, cell_align: float):
    """(W, U) float64 numpy constants of the QxQ block algebra.

    ``W[t_x, t_y, dx, dy, moment, channel]`` maps a fine cell's 16 moment
    sums to its deposit into corner ``(dx, dy)``; ``U[t_x, t_y, dx, dy,
    grid_ch, out_ch, coeff]`` maps the four corner values to the fine
    cell's sample coefficients over {1, x~, y~, x~y~} (the re-centering
    ``-cnt * x~`` is applied per agent from the count sample)."""
    t = np.arange(q, dtype=np.float64)
    frac0 = (t + 0.5) / q                       # weight at x~ = 0
    alpha = np.stack([1.0 - frac0, frac0], 1)   # [q, corner]
    beta = np.asarray([-1.0, 1.0]) / cell_align
    # corner-center offset: x_ref - corner_center = cf*(t + .5 - q*dx)
    cc = cell_fine * (t[:, None] + 0.5 - q * np.arange(2)[None, :])
    W = np.zeros((q, q, 2, 2, N_MOMENTS, N_CHANNELS))
    U = np.zeros((q, q, 2, 2, N_CHANNELS, N_CHANNELS, N_COEFFS))
    for tx in range(q):
        for ty in range(q):
            for dx in range(2):
                for dy in range(2):
                    a, b = alpha[tx, dx], beta[dx]
                    c, d = alpha[ty, dy], beta[dy]
                    cx_, cy_ = cc[tx, dx], cc[ty, dy]
                    # (ax + bx*x)(cy + dy*y) over {1, x, y, xy}
                    w4 = np.asarray([a * c, b * c, a * d, b * d])
                    sw = W[tx, ty, dx, dy]
                    sw[[0, 1, 2, 3], 4] = w4          # cnt: sum w
                    sw[[8, 9, 10, 11], 0] = w4        # vx:  sum w*vx
                    sw[[12, 13, 14, 15], 1] = w4      # vy:  sum w*vy
                    # relx = sum w*(x + Cx):  w*x over {x,x2,xy,x2y}
                    sw[[1, 4, 3, 6], 2] += w4
                    sw[[0, 1, 2, 3], 2] += cx_ * w4
                    sw[[2, 3, 5, 7], 3] += w4         # w*y terms
                    sw[[0, 1, 2, 3], 3] += cy_ * w4
                    su = U[tx, ty, dx, dy]
                    for ch in (0, 1, 4):              # vx, vy, cnt
                        su[ch, ch, :] += w4
                    # rel channels: corner value + cnt*(corner_center
                    # - pos) = (gv_rel - C*gv_cnt) - gv_cnt*x~; the
                    # -gv_cnt*x~ piece is applied per agent.
                    su[2, 2, :] += w4
                    su[4, 2, :] += -cx_ * w4
                    su[3, 3, :] += w4
                    su[4, 3, :] += -cy_ * w4
    return W, U


_device_tables: dict = {}


def block_tables(q: int, cell_fine: float, cell_align: float,
                 dtype: torch.dtype, device: torch.device):
    """(W, U) of :func:`_block_tensors` as ``dtype`` on ``device``, copied
    from the host once per geometry and device."""
    key = (q, cell_fine, cell_align, dtype, torch.device(device))
    tabs = _device_tables.get(key)
    if tabs is None:
        if (torch.device(device).type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError(
                "the moments field's tables are not on the card yet; call "
                "physics.prepare_tick (or block_tables) before capturing")
        tabs = tuple(torch.from_numpy(t).to(device=device, dtype=dtype)
                     for t in _block_tensors(q, cell_fine, cell_align))
        _device_tables[key] = tabs
    return tabs


def prepare(torus_hw: float, sep_cell: float, align_cell: Optional[float],
            dtype: torch.dtype, device: torch.device) -> None:
    """Ready the field's first use on ``device`` outside a CUDA graph's
    capture: the block tables copied there, and on the card the BLAS
    handle its einsums take (created at a first product, which a capture
    cannot do)."""
    _, cf, _, ca, q = commensurate_geometry(torus_hw, sep_cell, align_cell)
    w, _ = block_tables(q, cf, ca, dtype, device)
    einsum("i,i->", w[0, 0, 0, 0, :, 0], w[0, 0, 0, 0, :, 0])


def fine_cell_keys(
    pos: torch.Tensor,
    alive: Optional[torch.Tensor],
    torus_hw: float,
    g_fine: int,
) -> Keys:
    """(key, x~, y~): each agent's fine-cell key (dead agents keyed to
    ``g_fine**2``, out of range, so the deposit drops them) and its
    fine-cell-local coordinates.  Positions wrap onto the torus first, so
    an escaped agent's moments stay bounded (the corner form is periodic
    in pos); the binning is ``neighbors.torus_cell_xy``'s."""
    pos = mod(pos + torus_hw, 2.0 * torus_hw) - torus_hw
    cx, cy = torus_cell_xy(pos, torus_hw, g_fine)
    cell_fine = 2.0 * torus_hw / g_fine
    xt = pos[:, 0] - ((cx.to(pos.dtype) + 0.5) * cell_fine - torus_hw)
    yt = pos[:, 1] - ((cy.to(pos.dtype) + 0.5) * cell_fine - torus_hw)
    key = cx * g_fine + cy
    if alive is not None:
        key = torch.where(alive.bool(), key, g_fine * g_fine)
    return key, xt, yt


def _moment_rows(xt, yt, vel) -> torch.Tensor:
    """[N, 16] per-agent monomials (fine-cell-local coordinates keep every
    moment O(cell)-sized)."""
    one = torch.ones_like(xt)
    xy = xt * yt
    vx, vy = vel[:, 0], vel[:, 1]
    return torch.stack(
        [
            one, xt, yt, xy, xt * xt, yt * yt, xt * xt * yt,
            xt * yt * yt,
            vx, xt * vx, yt * vx, xy * vx,
            vy, xt * vy, yt * vy, xy * vy,
        ],
        dim=1,
    )


def sorted_cell_sums(skey: torch.Tensor, svals: torch.Tensor,
                     n_cells: int) -> torch.Tensor:
    """[n_cells, C] sums of ``svals`` [N, C] over each cell's run of the
    sorted keys ``skey`` [N] (keys >= ``n_cells`` are dropped).

    A segmented inclusive scan (log2 N rounds of shifted adds, each run
    restarting at its first row; JAX's ``seg_sums_sorted`` is the same
    operator under ``associative_scan``) read at each run's last row, found
    by a searchsorted.  Elementwise operations, one gather: a fixed order on
    every device, no atomics, no read from the device."""
    n = skey.shape[0]
    if n == 0:
        return svals.new_zeros((n_cells, svals.shape[1]))
    start = torch.cat([torch.ones_like(skey[:1], dtype=torch.bool),
                       skey[1:] != skey[:-1]])
    v, f = svals, start
    d = 1
    while d < n:
        v = torch.cat([v[:d], torch.where(f[d:, None], v[d:],
                                          v[d:] + v[:-d])])
        f = torch.cat([f[:d], f[d:] | f[:-d]])
        d *= 2
    cells = torch.arange(n_cells, dtype=skey.dtype, device=skey.device)
    lo = torch.searchsorted(skey, cells)
    hi = torch.searchsorted(skey, cells, right=True)
    last = v.index_select(0, (hi - 1).clamp(min=0))
    return torch.where((hi > lo)[:, None], last, 0.0)


def moments_deposit(
    pos: torch.Tensor,
    vel: torch.Tensor,
    alive: Optional[torch.Tensor],
    torus_hw: float,
    sep_cell: float,
    align_cell: Optional[float] = None,
    keys: Optional[Keys] = None,
    plan=None,
    deposit: str = "scatter",
) -> torch.Tensor:
    """The commensurate CIC deposit: the ``[g_align, g_align, 5]`` field of
    (velocity sum x2, center-relative position sum x2, count), equal up to
    the order of the sums to the four-corner bilinear scatter on the same
    grid.  ``keys``: a precomputed ``(key, x~, y~)`` binning.

    ``deposit``: ``"scatter"`` sums each fine cell's rows after a stable
    sort by ``key``; ``"sorted"`` reuses the shared ``plan``'s cell sort
    (``hashgrid_plan.plan_cell_sums``) and needs ``plan`` and its field
    ``keys``, on the plan's grid."""
    g, cf, ga, ca, q = commensurate_geometry(torus_hw, sep_cell, align_cell)
    key, xt, yt = (keys if keys is not None
                   else fine_cell_keys(pos, alive, torus_hw, g))
    rows = _moment_rows(xt, yt, vel)
    if deposit == "sorted":
        from .hashgrid_plan import plan_cell_sums

        if plan is None or keys is None:
            raise ValueError(
                "deposit='sorted' needs the shared hashgrid plan "
                "(plan=) and its field keys (keys=) — the sorted-"
                "segment form reduces over the plan's existing cell "
                "sort"
            )
        if plan.g != g:
            raise ValueError(
                f"deposit='sorted': plan grid (g={plan.g}) does not "
                f"match the field fine grid (g={g}) — the sorted "
                "deposit reduces over the plan's separation sort"
            )
        m = plan_cell_sums(plan, rows)
    elif deposit == "scatter":
        skey, order = torch.sort(key, stable=True)
        m = sorted_cell_sums(skey, rows.index_select(0, order), g * g)
    else:
        raise ValueError(
            f"unknown deposit {deposit!r}; expected 'scatter' or "
            "'sorted'"
        )
    m = m.reshape(g, g, N_MOMENTS)
    # Phase-align: fine cell s belongs to corner block (s - q/2)//q, so a
    # cyclic roll by -q/2 makes blocks contiguous (and closes the seam).
    m = torch.roll(m, (-(q // 2), -(q // 2)), dims=(0, 1))
    blocks = m.reshape(ga, q, ga, q, N_MOMENTS)
    w = block_tables(q, cf, ca, pos.dtype, pos.device)[0]
    # corner[a, b, dx, dy, ch]: what block (a, b) deposits into alignment
    # cell ((a+dx) mod ga, (b+dy) mod ga).
    corner = einsum("aibjm,ijdemc->abdec", blocks, w)
    grid = torch.zeros((ga, ga, N_CHANNELS), dtype=pos.dtype,
                       device=pos.device)
    for dx in (0, 1):
        for dy in (0, 1):
            grid = grid + torch.roll(corner[:, :, dx, dy, :], (dx, dy),
                                     dims=(0, 1))
    return grid


def moments_sample(
    grid: torch.Tensor,
    pos: torch.Tensor,
    vel: torch.Tensor,
    alive: Optional[torch.Tensor],
    torus_hw: float,
    sep_cell: float,
    align_cell: Optional[float] = None,
    keys: Optional[Keys] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(align, coh) [N, 2] sampled from a commensurate CIC ``grid``: one
    dense coefficient-table einsum, one 20-channel gather an agent and a
    polynomial.  No presence gate (a lone agent's self-sample is
    force-free), count floored at 1e-6."""
    g, cf, ga, ca, q = commensurate_geometry(torus_hw, sep_cell, align_cell)
    key, xt, yt = (keys if keys is not None
                   else fine_cell_keys(pos, alive, torus_hw, g))
    u = block_tables(q, cf, ca, pos.dtype, pos.device)[1]
    rolled = torch.stack(
        [torch.stack([torch.roll(grid, (-dx, -dy), dims=(0, 1))
                      for dy in (0, 1)], 0)
         for dx in (0, 1)], 0)                  # [2, 2, ga, ga, ch]
    coeff = einsum("deabn,ijdenck->aibjck", rolled, u)
    # Undo the phase roll so the table is indexed by the raw fine cell.
    coeff = coeff.reshape(g, g, N_CHANNELS, N_COEFFS)
    coeff = torch.roll(coeff, (q // 2, q // 2), dims=(0, 1))
    coeff = coeff.reshape(g * g, N_CHANNELS, N_COEFFS)
    cfa = coeff.index_select(0, key.clamp(max=g * g - 1).long())
    mono = torch.stack([torch.ones_like(xt), xt, yt, xt * yt], dim=1)
    samp = (cfa * mono[:, None, :]).sum(-1)     # [N, ch]
    cnt_raw = samp[:, 4]
    cnt = cnt_raw.clamp(min=1e-6)[:, None]
    align = samp[:, 0:2] / cnt - vel
    coh = torch.stack([samp[:, 2] - xt * cnt_raw,
                       samp[:, 3] - yt * cnt_raw], dim=1) / cnt
    if alive is not None:
        live = alive.bool()[:, None]
        align = torch.where(live, align, 0.0)
        coh = torch.where(live, coh, 0.0)
    return align, coh


def cic_field_commensurate(
    pos: torch.Tensor,
    vel: torch.Tensor,
    alive: Optional[torch.Tensor],
    torus_hw: float,
    sep_cell: float,
    align_cell: Optional[float] = None,
    keys: Optional[Keys] = None,
    plan=None,
    deposit: str = "scatter",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(align, coh) [N, 2]: the deposit and the sample sharing one binning
    (``keys``, e.g. the shared plan's ``hashgrid_plan.plan_field_keys``, or
    binned here)."""
    if keys is None:
        g, *_ = commensurate_geometry(torus_hw, sep_cell, align_cell)
        keys = fine_cell_keys(pos, alive, torus_hw, g)
    grid = moments_deposit(pos, vel, alive, torus_hw, sep_cell, align_cell,
                           keys=keys, plan=plan, deposit=deposit)
    return moments_sample(grid, pos, vel, alive, torus_hw, sep_cell,
                          align_cell, keys=keys)


def cic_field_corner_reference(
    pos: torch.Tensor,
    vel: torch.Tensor,
    alive: Optional[torch.Tensor],
    torus_hw: float,
    sep_cell: float,
    align_cell: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The four-corner bilinear CIC field on the same commensurate grid:
    the per-agent scatter and gather the moments form replaces, kept as
    the tests' oracle (its scatter adds with atomics on the card)."""
    _, _, ga, ca, _ = commensurate_geometry(torus_hw, sep_cell, align_cell)
    hw = torus_hw
    n, d = pos.shape
    live = (torch.ones(n, dtype=torch.bool, device=pos.device)
            if alive is None else alive.bool())

    def wrap(x):
        return mod(x + hw, 2.0 * hw) - hw

    u = div(pos + hw, ca) - 0.5
    i0 = torch.floor(u).to(torch.int32)
    frac = u - i0.to(pos.dtype)

    def corners():
        for dx in (0, 1):
            for dy in (0, 1):
                w = ((1 - frac[:, 0] if dx == 0 else frac[:, 0])
                     * (1 - frac[:, 1] if dy == 0 else frac[:, 1]))
                ci = torch.remainder(i0[:, 0] + dx, ga)
                cj = torch.remainder(i0[:, 1] + dy, ga)
                center = torch.stack(
                    [(ci.to(pos.dtype) + 0.5) * ca - hw,
                     (cj.to(pos.dtype) + 0.5) * ca - hw], dim=1)
                yield torch.where(live, w, 0.0), ci.long(), cj.long(), center

    grid = torch.zeros((ga, ga, 2 * d + 1), dtype=pos.dtype,
                       device=pos.device)
    for w, ci, cj, center in corners():
        rel = wrap(pos - center)
        depc = torch.cat([vel, rel, torch.ones_like(pos[:, :1])], dim=1)
        grid.index_put_((ci, cj), w[:, None] * depc, accumulate=True)

    samp = torch.zeros((n, 2 * d + 1), dtype=pos.dtype, device=pos.device)
    for w, ci, cj, center in corners():
        gv = grid[ci, cj]
        adj = torch.cat([gv[:, :d], gv[:, d:2 * d]
                         + gv[:, 2 * d:] * wrap(center - pos),
                         gv[:, 2 * d:]], dim=1)
        samp = samp + w[:, None] * adj
    cnt = samp[:, 2 * d:].clamp(min=1e-6)
    align = samp[:, :d] / cnt - vel
    coh = samp[:, d:2 * d] / cnt
    align = torch.where(live[:, None], align, 0.0)
    coh = torch.where(live[:, None], coh, 0.0)
    return align, coh
