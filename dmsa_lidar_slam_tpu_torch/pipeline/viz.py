# Copy of dmsa_lidar_slam_tpu/pipeline/viz.py; only this line differs.
"""Map / trajectory export for visualization.

The reference publishes RViz topics (/dmsa_slam/{map,submap,pose,traj};
src/dmsa_slam_ros.cpp:222-225,322-372).  This headless equivalent exports
standard files any viewer opens (CloudCompare, MeshLab, rerun, Open3D):

  - PLY point cloud of the global map (with optional per-keyframe colors),
  - PLY polyline of the trajectory,
  - a self-contained HTML viewer (three.js-free, canvas 2D top-down view)
    for quick remote inspection without any tooling.
"""

import os
from typing import Optional

import numpy as np


def save_ply_points(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None):
    """Binary little-endian PLY of [N,3] points (+ optional uint8 [N,3] colors)."""
    n = len(points)
    has_c = colors is not None
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += ["property float x", "property float y", "property float z"]
    if has_c:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if has_c:
            dt = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])
            arr = np.empty(n, dtype=dt)
            arr["xyz"] = points.astype(np.float32)
            arr["rgb"] = colors.astype(np.uint8)
            f.write(arr.tobytes())
        else:
            f.write(np.ascontiguousarray(points.astype(np.float32)).tobytes())


def save_trajectory_ply(path: str, positions: np.ndarray):
    """Trajectory as a PLY polyline (vertices + edges)."""
    n = len(positions)
    header = [
        "ply",
        "format binary_little_endian 1.0",
        f"element vertex {n}",
        "property float x",
        "property float y",
        "property float z",
        f"element edge {max(n - 1, 0)}",
        "property int vertex1",
        "property int vertex2",
        "end_header",
    ]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(np.ascontiguousarray(positions.astype(np.float32)).tobytes())
        if n > 1:
            edges = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1).astype("<i4")
            f.write(edges.tobytes())


def export_html_view(path: str, map_points: np.ndarray, trajectory: np.ndarray, title="DMSA map"):
    """Self-contained top-down HTML canvas view (no dependencies)."""
    pts = map_points[:: max(1, len(map_points) // 20000)]  # cap for file size
    data_pts = ",".join(f"[{x:.2f},{y:.2f}]" for x, y, _ in pts)
    data_trj = ",".join(f"[{x:.2f},{y:.2f}]" for x, y, _ in trajectory)
    html = f"""<!DOCTYPE html><html><head><title>{title}</title></head><body style="margin:0;background:#111">
<canvas id="c" width="1200" height="900" style="display:block;margin:auto"></canvas>
<script>
const pts=[{data_pts}], trj=[{data_trj}];
const c=document.getElementById('c'),g=c.getContext('2d');
const xs=pts.map(p=>p[0]).concat(trj.map(p=>p[0])), ys=pts.map(p=>p[1]).concat(trj.map(p=>p[1]));
const x0=Math.min(...xs),x1=Math.max(...xs),y0=Math.min(...ys),y1=Math.max(...ys);
const s=Math.min(1100/(x1-x0+1e-6),820/(y1-y0+1e-6));
const X=x=>50+(x-x0)*s, Y=y=>860-(y-y0)*s;
g.fillStyle='#6af';for(const[x,y] of pts)g.fillRect(X(x),Y(y),1.5,1.5);
g.strokeStyle='#f80';g.lineWidth=2;g.beginPath();
trj.forEach(([x,y],i)=>i?g.lineTo(X(x),Y(y)):g.moveTo(X(x),Y(y)));g.stroke();
</script></body></html>"""
    with open(path, "w") as f:
        f.write(html)


def export_all(slam, out_dir: str):
    """Export map PLY + trajectory PLY + HTML view from either pipeline."""
    os.makedirs(out_dir, exist_ok=True)
    pts = slam.map_points()
    if pts is None or len(pts) == 0:
        return []
    if hasattr(slam, "keyframe_poses"):
        _, transl, _ = slam.keyframe_poses()
    else:
        transl = slam.kf_map.transl_w[: slam.kf_map.count]
    written = []
    p1 = os.path.join(out_dir, "map.ply")
    save_ply_points(p1, pts)
    written.append(p1)
    p2 = os.path.join(out_dir, "trajectory.ply")
    save_trajectory_ply(p2, np.asarray(transl, dtype=float))
    written.append(p2)
    p3 = os.path.join(out_dir, "view.html")
    export_html_view(p3, pts, np.asarray(transl, dtype=float))
    written.append(p3)
    return written
