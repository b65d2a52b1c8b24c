"""window.gn_tables_ms: host ms per window Gauss-Newton iteration in the
optimizer's `window.gn.tables` span (the pose tables, their jacfwd
and the line search's vmap of them) over the window's scans.  Window branch
of the step (dmsa/optimizer.py _iteration)."""


def read(run):
    st = run["stages"]
    tables, iters = st.get("window.gn.tables"), st.get("window.gn.iters")
    if not tables or not iters or not iters["count"]:
        return None
    return 1e3 * tables["total_s"] / iters["count"]
