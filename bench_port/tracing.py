"""The benchmark's yardstick for a profiled stretch of scans: the card's
published peaks, the operations and bytes of K1 and K2 from their shapes,
and the reduction of a torch.profiler session to counts and times.

The arithmetic is copied from the program's tools so that a later change
to the program cannot change it:
  - busy time (dmsa_lidar_slam_tpu_torch/pipeline/traceutil.py, and
    chip_smoke.py's _events_busy): the sum of the card's kernel, copy and
    memset spans.  The program runs on one stream, so the spans do not
    overlap;
  - launches and syncs (traceutil.host_call_counts): runtime calls on the
    host;
  - the bound (chip_smoke.py _bound): bytes over the HBM bandwidth or f32
    operations over the f32 rate outside the tensor cores, the larger;
  - K1's and K2's bytes and operations (chip_smoke.py _k1_row, _k2_row),
    each input byte read once and each output byte written once, masked
    slots counted for what they need: their mask or weight and their
    output row.

The session is read from the profiler's raw events; no Chrome trace is
written.
"""

import collections
import contextlib

import numpy as np

# NVIDIA H100 SXM, published dense peaks at the 700 W limit: HBM3 bytes/s
# and f32 operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
K1_RANGE, K2_RANGE = "bench_port.k1", "bench_port.k2"
NAME_CHARS = 160  # of a kernel or host span name in the breakdown


def bound_s(n_bytes, n_ops):
    """The least time the card needs for the work, in seconds."""
    return max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_OPS_S)


def k1_work(n, n_valid, n_cells, tab_rows, split, obs, rows12):
    """(bytes, operations) of one K1 call over n slots, n_valid unmasked,
    n_cells occupied cells.  A valid slot reads its point, mask, ring,
    local point and int64 table index (37 bytes; 4 more each for split
    ids and weights) and writes its 16 packed rows (64 bytes); a masked
    slot reads its mask and writes its rows; the compact layout reads the
    [Dtab, 8] f32 table.  Operations: ~45 per valid point (transform,
    moments), ~200 per cell (the floored inverse)."""
    per_valid = 101 + 4 * bool(split) + 4 * bool(obs)
    n_bytes = per_valid * n_valid + 65 * (n - n_valid) + (0 if rows12 else 32 * tab_rows)
    return n_bytes, 45 * n_valid + 200 * n_cells


def k2_work(m, m_valid, n_cells, tab_rows, p_dim):
    """(bytes, operations) of one K2 call: the table and its Jacobian
    [(1 + P) Dtab, 8] f32, the packed rows of the valid members (64 bytes;
    4, the weight row, for a masked slot), the [P+1, P+1] f32 result; per
    valid member its cotangent (~40) and the 7P-wide contraction (14 P),
    per cell the rank-1 update of the system (2 (P+1)^2)."""
    n_bytes = 32 * tab_rows * (1 + p_dim) + 64 * m_valid + 4 * (m - m_valid) + 4 * (p_dim + 1) ** 2
    return n_bytes, m_valid * (40 + 14 * p_dim) + 2 * n_cells * (p_dim + 1) ** 2


class KernelCalls:
    """Records each K1 / K2 call's operands while installed (references
    only: the counts that need the card are read after the session) and
    names the call's span in the profile."""

    def __init__(self, fr_module):
        self.fr = fr_module
        self.k1, self.k2 = [], []
        self.on = False

    @contextlib.contextmanager
    def installed(self):
        import torch

        build, gn = self.fr.build_packed, self.fr.gn_system

        def build_rec(points_w, mask, ring_ids, xs, tidx, grid_size, min_points, tab=None, split_ids=None,
                      obs_weight=None):
            if not self.on:
                return build(points_w, mask, ring_ids, xs, tidx, grid_size, min_points, tab, split_ids, obs_weight)
            with torch.profiler.record_function(K1_RANGE):
                out = build(points_w, mask, ring_ids, xs, tidx, grid_size, min_points, tab, split_ids, obs_weight)
            self.k1.append(dict(mask=mask, num_raw=out[2], tab_rows=0 if tab is None else int(tab.shape[0]),
                                split=split_ids is not None, obs=obs_weight is not None,
                                rows12=tab is None or obs_weight is not None))
            return out

        def gn_rec(tab, dtabs, packed, max_cells=None):
            if not self.on:
                return gn(tab, dtabs, packed, max_cells=max_cells)
            with torch.profiler.record_function(K2_RANGE):
                out = gn(tab, dtabs, packed, max_cells=max_cells)
            self.k2.append(dict(packed=packed, tab_rows=int(tab.shape[0]), p_dim=int(dtabs.shape[0])))
            return out

        self.fr.build_packed, self.fr.gn_system = build_rec, gn_rec
        try:
            yield self
        finally:
            self.fr.build_packed, self.fr.gn_system = build, gn

    def bounds(self):
        """(K1 bound s, K2 bound s) summed over the recorded calls."""
        k1 = 0.0
        for c in self.k1:
            n = int(c["mask"].shape[0])
            b, o = k1_work(n, int(c["mask"].sum()), int(c["num_raw"]), c["tab_rows"], c["split"], c["obs"],
                           c["rows12"])
            k1 += bound_s(b, o)
        k2 = 0.0
        for c in self.k2:
            pk = c["packed"]
            valid = (pk[6:12].abs().sum(0) > 0) & (pk[12] > 0)
            b, o = k2_work(int(pk.shape[1]), int(valid.sum()), int((pk[15] > 0).sum()), c["tab_rows"], c["p_dim"])
            k2 += bound_s(b, o)
        return k1, k2


RUNTIME_PREFIXES = ("cuda", "cu")


def _on_card(e):
    import torch

    return e.device_type() == torch.autograd.DeviceType.CUDA


def summarize(events, n_scans, wall_s, top=10):
    """Counts and times of a profiled stretch of `n_scans` scans that took
    `wall_s` on the host clock, from the profiler's raw events
    (profile.profiler.kineto_results.events(): building profile.events()
    takes minutes at ~10^5 launches)."""
    host = [e for e in events if not _on_card(e)]
    host_names = {e.name() for e in host}
    # the card's spans: kernels, copies and memsets; its mirrors of host
    # ranges carry the host range's name and span kernels, so they go
    card = [e for e in events if _on_card(e) and e.name() not in host_names]
    calls, runtime = collections.Counter(), {}
    for e in host:
        if e.name().startswith(RUNTIME_PREFIXES):
            calls[e.name()] += 1
            runtime[e.correlation_id()] = e.start_ns()
    busy_ns = sum(e.duration_ns() for e in card)
    by_name = collections.Counter()
    for e in card:
        by_name[e.name()] += e.duration_ns()
    ranges = {K1_RANGE: [], K2_RANGE: []}
    for e in host:
        if e.name() in ranges:
            ranges[e.name()].append((e.start_ns(), e.end_ns()))
    in_range = {k: 0 for k in ranges}
    for k, spans in ranges.items():
        if not spans:
            continue
        spans.sort()
        lo = np.array([a for a, _ in spans])
        hi = np.array([b for _, b in spans])
        for e in card:
            t = runtime.get(e.correlation_id(), runtime.get(e.linked_correlation_id()))
            if t is None:
                continue
            j = np.searchsorted(lo, t, side="right") - 1
            if j >= 0 and t < hi[j]:
                in_range[k] += e.duration_ns()
    return dict(
        scans=n_scans,
        wall_s=wall_s,
        busy_s=busy_ns / 1e9,
        launches=sum(calls.get(n, 0) for n in LAUNCH_CALLS),
        syncs=sum(calls.get(n, 0) for n in SYNC_CALLS),
        k1_device_s=in_range[K1_RANGE] / 1e9,
        k2_device_s=in_range[K2_RANGE] / 1e9,
        device_ops=[[n[:NAME_CHARS], ns / 1e9] for n, ns in by_name.most_common(top)],
        idle_gaps=idle_gaps(host, card, top),
    )


def idle_gaps(host, card, top=10, longest=400):
    """The card's idle time between its spans, by what the host was doing:
    the `longest` gaps, each named by the innermost host span (an op, a
    runtime call or a named range) open when it began, summed by name."""
    if not card:
        return []
    spans = sorted((e.start_ns(), e.end_ns()) for e in card)
    starts = np.array([s for s, _ in spans], dtype=np.float64)
    ends = np.maximum.accumulate(np.array([e for _, e in spans], dtype=np.float64))
    gap_at, gap_len = ends[:-1], starts[1:] - ends[:-1]
    order = np.argsort(-gap_len)[:longest]
    h_start = np.array([e.start_ns() for e in host], dtype=np.float64)
    h_end = np.array([e.end_ns() for e in host], dtype=np.float64)
    h_len = h_end - h_start
    names = [e.name() for e in host]
    out = collections.Counter()
    for i in order:
        if gap_len[i] <= 0:
            break
        t = gap_at[i]
        open_ = np.nonzero((h_start <= t) & (h_end > t))[0]
        name = names[open_[np.argmin(h_len[open_])]] if len(open_) else "(no host span)"
        out[name] += gap_len[i] / 1e9
    return [[n[:NAME_CHARS], s] for n, s in out.most_common(top)]
