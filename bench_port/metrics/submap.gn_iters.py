"""submap.gn_iters: Gauss-Newton iterations per submap solve over the
window's scans, the optimizer's counter `submap.gn.iters` over the calls
of the `submap.optimize` span.  Submap solve of the keyframe branch
(pipeline/fused.py do_submap, K1-K3; the solve stops at
num_iter_keyframe_optim or earlier).  A program without that span (before
it existed) or a window without a solve reads nothing."""


def read(run):
    st = run["stages"]
    iters, solves = st.get("submap.gn.iters"), st.get("submap.optimize")
    if not iters or not solves or not solves["calls"]:
        return None
    return iters["count"] / solves["calls"]
