"""The DMSA Gauss-Newton optimizer, tabular and structured paths
(counterpart of dmsa_lidar_slam_tpu/dmsa/optimizer.py).

Per iteration (DmsaOptimizer.h:54-150 semantics): rebuild Gaussian cells at
two grid resolutions from the current points, freeze membership and
information matrices, form the Gauss-Newton normal equations, take a
damped step with an infinity-norm clip, and run the line search.

  - tabular path (the fused pipeline): cell build K1, normal equations K2,
    line search over candidate 0 (the unstepped params) plus the step
    fractions K3.  The tables, their Jacobian and the candidate tables come
    from the problem's tables_jac and tables_batch (on the card the
    window's K6, the submap's K7; on the CPU torch.func's twins);
  - structured path (the host pipeline): gaussians.build_cells, the closed
    form per-point residual gradient contracted against the problem's
    pose-table Jacobian (from the same tables_jac builders),
    J^T J in the pose dtype, and the line search as a loop over the step
    fractions, each a forward plus the frozen cell residuals;
  - autodiff path (neither given; the two-scan problem of dmsa.problems):
    the residual vector over the merged cells of both resolutions and its
    Jacobian by forward-mode AD (value_and_jacfwd), and the line search as
    one batched pass over the step fractions (torch.func.vmap).

The loop stops on the host when an iteration sets `done` (one device sync
per iteration).
"""

import contextlib
import dataclasses
import functools
from typing import Any, Callable, NamedTuple, Optional

import torch

from dmsa_lidar_slam_tpu_torch.ops import fused_residuals as fr
from dmsa_lidar_slam_tpu_torch.ops import gaussians, voxel

# stop reason codes
STOP_NONE = 0
STOP_TOO_FEW_GAUSSIANS = 1  # DmsaOptimizer.h:89-93
STOP_NAN = 2  # DmsaOptimizer.h:116-122
STOP_NO_IMPROVEMENT = 3  # DmsaOptimizer.h:130-134
STOP_EPSILON = 4  # DmsaOptimizer.h:138-143


class ForwardOut(NamedTuple):
    points: torch.Tensor  # [N, 3] current global points
    mask: torch.Tensor  # [N] bool
    ring_ids: torch.Tensor  # [N]
    extra: torch.Tensor  # [E] additional residuals
    split_ids: Optional[torch.Tensor] = None  # [N] cell-split channel
    obs_weight: Optional[torch.Tensor] = None  # [N] observation weight (getWeightOfPointSet); None: 1


class TabularProblem(NamedTuple):
    """A problem in indexed-affine-table form (see ops.fused_residuals).

    n_table       table rows including the trailing identity row
    tables        (params, data) -> (tab [n_table, 8] f32, extra [E])
    point_arrays  data -> (xs [N, 3] f32, tidx [N] int64)
    tables_jac    (params, data) -> (tab, extra, dtab [P, n_table, 8] f32,
                  j_extra [P, E])
    tables_batch  (cand_params [K, P], data) -> (tabs [K, n_table, 8] f32,
                  extras [K, E])
    forward_tab   (tab, extra, data) -> ForwardOut at the table's params;
                  default: the optimizer's forward function at the params
    """

    n_table: int
    tables: Callable
    point_arrays: Callable
    tables_jac: Callable
    tables_batch: Callable
    forward_tab: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class OptimSettings:
    """Mirror of DmsaOptimSettings (DmsaOptimizer.h:25-39)."""

    num_iter: int = 15
    epsilon: float = 1e-5
    step_length_optim: float = 0.05
    max_step: float = 0.01
    grid_size_1_factor: float = 2.0
    grid_size_2_factor: float = 5.0
    min_num_points_per_set: int = 6
    min_num_gaussians: int = 30
    lambda_diag: float = 1e-5
    use_centralization: bool = True
    jacobian_chunk: int = 128  # tangents per forward-mode block (memory bound)
    line_search_fracs: tuple = (
        0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.05, 0.02, 0.01, 0.005, 0.002,
    )


class OptimResult(NamedTuple):
    params: torch.Tensor
    num_iters: torch.Tensor
    stop_reason: torch.Tensor
    final_error: torch.Tensor
    initial_error: torch.Tensor
    num_gaussians: torch.Tensor


def chunked_jacfwd(fn: Callable, params: torch.Tensor, chunk: int) -> torch.Tensor:
    """J[i, j] = d fn(params)_i / d params_j, `chunk` tangents at a time."""
    return value_and_jacfwd(fn, params, chunk)[1]


def value_and_jacfwd(fn: Callable, params: torch.Tensor, chunk: int):
    """(fn(params), J [R, P]) by forward-mode AD: torch.func.jvp under
    torch.func.vmap over each block of `chunk` unit tangents.  Inside a
    block the primal runs once, unbatched beside the batched tangents, and
    the first block's primal output is the value, so no separate forward
    pass is needed; with P <= chunk (the default 128 covers the two-scan
    problem and the window) the whole Jacobian costs one primal pass, as
    the reference's one jax.linearize does."""
    p = params.shape[0]
    eye = torch.eye(p, dtype=params.dtype, device=params.device)
    push = torch.func.vmap(lambda t: torch.func.jvp(fn, (params,), (t,)), out_dims=(None, 0))
    e0, cols = None, []
    for start in range(0, p, chunk):
        e, block = push(eye[start : start + chunk])  # [R], [chunk, R]
        e0 = e if e0 is None else e0
        cols.append(block)
    return e0, torch.cat(cols, dim=0).T


def tables_and_jacobian(tab_fn, params):
    """(tab [Dtab, 8], extra [E], dtab [P, Dtab, 8], j_extra [P, E]): a
    table builder's tables at params and their Jacobian by
    torch.func.jacfwd."""
    tab, extra = tab_fn(params)
    jtab, jextra = torch.func.jacfwd(tab_fn)(params)  # [Dtab, 8, P], [E, P]
    return tab, extra, jtab.permute(2, 0, 1), jextra.T


def residuals(forward_fn, params, merged_cells, data):
    """Residual vector over the merged per-resolution cell layout (one pass
    instead of one per resolution).  Its squared total equals the per-
    resolution layout's, so it interchanges with the structured path's e0
    in every dot product."""
    out = forward_fn(params, data)
    res = gaussians.cell_residuals(out.points, out.mask, merged_cells)
    rdt = torch.promote_types(res.dtype, out.extra.dtype)
    return torch.cat([res.to(rdt), out.extra.to(rdt)])


def _no_span(part):
    return contextlib.nullcontext()


def _iteration(forward_fn, tabular_fn, params, data, settings, min_grid_size, step_length, max_step, span=_no_span):
    """One tabular Gauss-Newton iteration.  span(part) times its host parts:
    "tables" (the pose tables and their Jacobian, and the line search's
    candidate tables) and "cells" (the forward, the K1 builds, K2, the
    solve, K3 and _finish); no span sits inside a transformed function."""
    pdt, dev = params.dtype, params.device
    num_params = params.shape[0]
    forward_tab = tabular_fn.forward_tab or (lambda tab, extra, d: forward_fn(params, d))

    with span("tables"):
        tab, extra0, dtab, j_extra = tabular_fn.tables_jac(params, data)

    with span("cells"):
        out = forward_tab(tab, extra0, data)
        xs, tidx = tabular_fn.point_arrays(data)
        packs, nvs = [], []
        for factor in (settings.grid_size_1_factor, settings.grid_size_2_factor):
            if factor > 1e-30:
                pk, nv, _ = fr.build_packed(
                    out.points, out.mask, out.ring_ids, xs, tidx, factor * min_grid_size,
                    settings.min_num_points_per_set, tab, split_ids=out.split_ids, obs_weight=out.obs_weight,
                )
                packs.append(pk)
                nvs.append(nv)
        packed = packs[0] if len(packs) == 1 else torch.cat(packs, dim=1)
        n_gauss = sum(nv.to(torch.int64) for nv in nvs)

        max_cells = packed.shape[1] // max(1, settings.min_num_points_per_set) + len(packs)
        hext = fr.gn_system(tab, dtab, packed, max_cells=max_cells)
        H = hext[:num_params, :num_params].to(pdt)
        g = hext[:num_params, num_params].to(pdt)
        je = j_extra.to(pdt)
        H = H + je @ je.T + settings.lambda_diag * torch.eye(num_params, dtype=pdt, device=dev)
        g = g + je @ extra0.to(pdt)
        step, nan_step = _clipped_step(H, g, step_length, max_step)

        ks = torch.tensor(settings.line_search_fracs, dtype=pdt, device=dev)
        cand_params = torch.cat([params[None, :], params[None, :] + ks[:, None] * step[None, :]], dim=0)
    with span("tables"):
        tabs, extras = tabular_fn.tables_batch(cand_params, data)
    with span("cells"):
        errs = fr.cand_errors(tabs, packed).to(pdt) + torch.sum(extras.to(pdt) ** 2, dim=1)
        return _finish(params, cand_params, errs, step, nan_step, n_gauss, settings)


def _clipped_step(H, g, step_length, max_step):
    """-step_length * H^-1 g, zeroed if NaN, clipped in the infinity norm
    (DmsaOptimizer.h:116-128).  Returns (step, nan_step)."""
    step = -step_length * torch.linalg.solve(H, g)
    nan_step = torch.any(torch.isnan(step))
    step = torch.where(nan_step, torch.zeros_like(step), step)
    max_elem = torch.max(torch.abs(step))
    step = torch.where(max_elem > max_step, (max_step / torch.clamp(max_elem, min=1e-30)) * step, step)
    return step, nan_step


def _finish(params, cand_params, errs, step, nan_step, n_gauss, settings):
    """Line-search argmin over errs [1 + K] (row 0: the unstepped params)
    and the stop decision.  Aborts keep the pre-step params
    (DmsaOptimizer.h:118,136)."""
    best = torch.argmin(errs)
    new_params = torch.where(best > 0, cand_params[best], params)
    new_error = errs[best]
    too_few = n_gauss < settings.min_num_gaussians
    no_improve = best == 0
    eps_stop = torch.linalg.norm(step) < settings.epsilon
    stop_reason = torch.where(
        too_few,
        STOP_TOO_FEW_GAUSSIANS,
        torch.where(
            nan_step, STOP_NAN, torch.where(no_improve, STOP_NO_IMPROVEMENT, torch.where(eps_stop, STOP_EPSILON, STOP_NONE))
        ),
    )
    accept = ~(too_few | nan_step | no_improve)
    params_out = torch.where(accept, new_params, params)
    done = too_few | nan_step | no_improve | eps_stop
    return params_out, done, stop_reason.to(torch.int32), new_error, n_gauss.to(torch.int32)


def _build_all_cells(out, settings, min_grid_size):
    cells = []
    for factor in (settings.grid_size_1_factor, settings.grid_size_2_factor):
        if factor > 1e-30:
            cells.append(
                gaussians.build_cells(
                    out.points, out.mask, out.ring_ids, factor * min_grid_size,
                    settings.min_num_points_per_set, split_ids=out.split_ids, obs_weight=out.obs_weight,
                )
            )
    return cells


def _iteration_structured(forward_fn, structured_fn, params, data, settings, min_grid_size, step_length, max_step):
    """One Gauss-Newton iteration on the structured Jacobian: per cell set,
    the closed-form residual gradient per point, contracted to parameter
    rows by the problem (contract) and summed over each cell's members."""
    pdt, dev = params.dtype, params.device
    num_params = params.shape[0]
    out, contract, j_extra = structured_fn(params, data)
    cells = _build_all_cells(out, settings, min_grid_size)
    merged = gaussians.concat_cells(cells, out.points.shape[0])
    e_parts, j_parts = [], []
    for c in cells:
        res, g_sorted = gaussians.cell_residuals_and_grad(out.points, out.mask, c)
        g_orig = torch.zeros_like(out.points).index_copy_(0, c.order, g_sorted)
        jp = contract(g_orig)  # [N, P] per-point rows, original order
        jc = voxel.run_sums(jp[c.order], c.runs)  # cell sums, kept at run starts below
        e_parts.append(res)
        j_parts.append(torch.where(c.valid[:, None], jc, torch.zeros_like(jc)))
    rdt = torch.promote_types(e_parts[0].dtype, out.extra.dtype)
    e0 = torch.cat([e.to(rdt) for e in e_parts] + [out.extra.to(rdt)])
    J = torch.cat([j.to(rdt) for j in j_parts + [j_extra]], dim=0)
    n_gauss = sum(c.num_valid.to(torch.int64) for c in cells)
    error0 = torch.dot(e0, e0)

    H = J.T @ J + settings.lambda_diag * torch.eye(num_params, dtype=J.dtype, device=dev)
    step, nan_step = _clipped_step(H, J.T @ e0, step_length, max_step)

    ks = torch.tensor(settings.line_search_fracs, dtype=pdt, device=dev)
    cand_params = params[None, :] + ks[:, None] * step[None, :]
    cand_err = []
    for p in cand_params:  # one forward and one frozen-cell residual pass per step fraction
        e = residuals(forward_fn, p, merged, data)
        cand_err.append(torch.dot(e, e))
    errs = torch.stack([error0] + cand_err)
    cand_params = torch.cat([params[None, :], cand_params], dim=0)
    return _finish(params, cand_params, errs, step, nan_step, n_gauss, settings)


def _iteration_autodiff(forward_fn, params, data, settings, min_grid_size, step_length, max_step):
    """One Gauss-Newton iteration on the forward-mode Jacobian of the
    residuals over the frozen merged cells; the line search evaluates the
    14 step fractions in one batched pass."""
    pdt, dev = params.dtype, params.device
    num_params = params.shape[0]
    out = forward_fn(params, data)
    cells = _build_all_cells(out, settings, min_grid_size)
    merged = gaussians.concat_cells(cells, out.points.shape[0])

    def res_fn(p):
        return residuals(forward_fn, p, merged, data)

    e0, J = value_and_jacfwd(res_fn, params, settings.jacobian_chunk)
    n_gauss = sum(c.num_valid.to(torch.int64) for c in cells)
    error0 = torch.dot(e0, e0)

    H = J.T @ J + settings.lambda_diag * torch.eye(num_params, dtype=J.dtype, device=dev)
    step, nan_step = _clipped_step(H, J.T @ e0, step_length, max_step)

    ks = torch.tensor(settings.line_search_fracs, dtype=pdt, device=dev)
    cand_params = params[None, :] + ks[:, None] * step[None, :]
    cand_err = torch.func.vmap(lambda p: (lambda e: torch.dot(e, e))(res_fn(p)))(cand_params)
    errs = torch.cat([error0[None], cand_err])
    cand_params = torch.cat([params[None, :], cand_params], dim=0)
    return _finish(params, cand_params, errs, step, nan_step, n_gauss, settings)


def optimize(
    forward_fn: Callable[[torch.Tensor, Any], ForwardOut],
    params0: torch.Tensor,
    data: Any,
    settings: OptimSettings,
    min_grid_size=0.3,
    step_length=None,
    max_step=None,
    tabular_fn: Optional[TabularProblem] = None,
    structured_fn: Optional[Callable] = None,
    metrics=None,
    name: Optional[str] = None,
) -> OptimResult:
    """Run the DMSA optimization on the tabular (kernel) path when
    tabular_fn is given, on the structured path when structured_fn is
    given, else on the autodiff path.

    structured_fn(params, data) -> (ForwardOut, contract, J_extra [E, P]),
    where contract(grad3 [N, 3]) -> [N, P] maps per-point residual
    cotangents to parameter rows.  step_length / max_step optionally
    override the settings (tensors or floats).  Centralization is the
    caller's (it rewrites the data).

    With a pipeline.metrics.Metrics, each iteration records the spans
    `<name>.gn.tables` and `<name>.gn.cells` (tabular path) and
    `<name>.gn.stop` (the stop read, the host's wait on the device), the
    counter `<name>.gn.iters` the iterations run, and on the tabular path
    `<name>.gn.tables_kernel` the calls of the problem's tables_jac and
    tables_batch made on CUDA tensors (two an iteration on the card, 0 on
    the CPU) and the device counter `<name>.gn.k1_long_positions`, the
    sorted positions of K1's calls that lay in runs longer than one chunk
    (fused_residuals.long_positions_into: read once, by summary())."""
    def span(part):
        return _no_span(part) if metrics is None else metrics.stage(f"{name}.gn.{part}")

    if tabular_fn is not None:
        iteration = functools.partial(_iteration, forward_fn, tabular_fn, span=span)
    elif structured_fn is not None:
        iteration = functools.partial(_iteration_structured, forward_fn, structured_fn)
    else:
        iteration = functools.partial(_iteration_autodiff, forward_fn)
    dev, pdt = params0.device, params0.dtype
    step_length = settings.step_length_optim if step_length is None else step_length
    max_step = settings.max_step if max_step is None else max_step
    inf = torch.tensor(float("inf"), dtype=pdt, device=dev)
    params = params0
    reason = torch.tensor(STOP_NONE, dtype=torch.int32, device=dev)
    err, err0 = inf, inf
    ng = torch.tensor(0, dtype=torch.int32, device=dev)
    iters = 0
    counting = contextlib.nullcontext()
    if metrics is not None and tabular_fn is not None:
        counting = fr.long_positions_into(metrics.device_counter(f"{name}.gn.k1_long_positions", dev))
    with counting:
        for _ in range(settings.num_iter):
            params, done, reason, err, ng = iteration(params, data, settings, min_grid_size, step_length, max_step)
            if iters == 0:
                err0 = err
            iters += 1
            with span("stop"):
                stop = bool(done)  # host sync: the stop decision
            if stop:
                break
    if metrics is not None:
        metrics.count(f"{name}.gn.iters", iters)
        if tabular_fn is not None:
            metrics.count(f"{name}.gn.tables_kernel", 2 * iters if params0.is_cuda else 0)
    return OptimResult(
        params=params,
        num_iters=torch.tensor(iters, dtype=torch.int32, device=dev),
        stop_reason=reason,
        final_error=err,
        initial_error=err0,
        num_gaussians=ng,
    )
