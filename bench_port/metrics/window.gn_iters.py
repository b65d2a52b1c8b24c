"""window.gn_iters: Gauss-Newton iterations per window solve over the
window's scans, the optimizer's counter `window.gn.iters` over the calls
of the `window.optimize` span.  Window branch of the step (the solve stops
at num_iter_sliding_window_optim or earlier)."""


def read(run):
    st = run["stages"]
    iters, solves = st.get("window.gn.iters"), st.get("window.optimize")
    if not iters or not solves or not solves["calls"]:
        return None
    return iters["count"] / solves["calls"]
