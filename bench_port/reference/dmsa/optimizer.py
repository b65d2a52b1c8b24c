"""The DMSA Gauss-Newton optimizer on the tabular path, the one the fused
step runs (counterpart of dmsa_lidar_slam_tpu/dmsa/optimizer.py).

Per iteration (DmsaOptimizer.h:54-150 semantics): rebuild Gaussian cells at
two grid resolutions from the current points, freeze membership and
information matrices, form the Gauss-Newton normal equations, take a
damped step with an infinity-norm clip, and run the line search: cell
build K1, normal equations K2, line search over candidate 0 (the unstepped
params) plus the step fractions K3, each as its plain version.  The table
Jacobian comes from torch.func.jacfwd over the table builder, the
candidate tables from torch.func.vmap.

The loop stops on the host when an iteration sets `done` (one device sync
per iteration).
"""

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch


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
    """

    n_table: int
    tables: Callable
    point_arrays: Callable


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


def _iteration(forward_fn, tabular_fn, params, data, settings, min_grid_size, step_length, max_step):
    from bench_port.reference.ops import fused_residuals as fr

    pdt, dev = params.dtype, params.device
    num_params = params.shape[0]
    out = forward_fn(params, data)
    xs, tidx = tabular_fn.point_arrays(data)

    def tab_fn(p):
        return tabular_fn.tables(p, data)

    tab, extra0 = tab_fn(params)
    jtab, jextra = torch.func.jacfwd(tab_fn)(params)  # [Dtab, 8, P], [E, P]
    dtab = jtab.permute(2, 0, 1)  # [P, Dtab, 8]
    j_extra = jextra.T  # [P, E]

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
    tabs, extras = torch.func.vmap(tab_fn)(cand_params)
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


def optimize(
    forward_fn: Callable[[torch.Tensor, Any], ForwardOut],
    params0: torch.Tensor,
    data: Any,
    settings: OptimSettings,
    min_grid_size=0.3,
    step_length=None,
    max_step=None,
    *,
    tabular_fn: TabularProblem,
) -> OptimResult:
    """Run the DMSA optimization on the tabular path.  step_length /
    max_step optionally override the settings (tensors or floats).
    Centralization is the caller's (it rewrites the data)."""
    dev, pdt = params0.device, params0.dtype
    step_length = settings.step_length_optim if step_length is None else step_length
    max_step = settings.max_step if max_step is None else max_step
    inf = torch.tensor(float("inf"), dtype=pdt, device=dev)
    params = params0
    reason = torch.tensor(STOP_NONE, dtype=torch.int32, device=dev)
    err, err0 = inf, inf
    ng = torch.tensor(0, dtype=torch.int32, device=dev)
    iters = 0
    for _ in range(settings.num_iter):
        params, done, reason, err, ng = _iteration(forward_fn, tabular_fn, params, data, settings, min_grid_size,
                                                   step_length, max_step)
        if iters == 0:
            err0 = err
        iters += 1
        if bool(done):  # host sync: the stop decision
            break
    return OptimResult(
        params=params,
        num_iters=torch.tensor(iters, dtype=torch.int32, device=dev),
        stop_reason=reason,
        final_error=err,
        initial_error=err0,
        num_gaussians=ng,
    )
