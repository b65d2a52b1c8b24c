"""submap.iter_ms: host ms per submap Gauss-Newton iteration, the
`submap.optimize` span's total over the optimizer's counter
`submap.gn.iters`, over the window's scans.  With submap.gn_iters it
tells a faster solve from one of fewer iterations.  Submap solve of the
keyframe branch (pipeline/fused.py do_submap, K1-K3).  A program without
that span or a window without a solve reads nothing."""


def read(run):
    st = run["stages"]
    solves, iters = st.get("submap.optimize"), st.get("submap.gn.iters")
    if not solves or not iters or not iters["count"]:
        return None
    return 1e3 * solves["total_s"] / iters["count"]
