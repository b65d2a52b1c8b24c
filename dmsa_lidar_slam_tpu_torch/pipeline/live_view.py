# Copy of dmsa_lidar_slam_tpu/pipeline/live_view.py; only this line differs.
"""Live map / trajectory viewer — the RViz-equivalent for headless TPU runs.

The reference publishes the global map, current submap, pose, and keyframe
trajectory to RViz topics on every scan (reference:
src/dmsa_slam_ros.cpp:222-225,322-372).  This module serves the same live
state over HTTP instead: the runner calls `publish(slam)` from the main
loop (like the reference's per-scan publish), a snapshot is cached under a
lock, and a tiny self-refreshing HTML page polls it.

    server = LiveViewServer(port=8008)
    server.start()
    ... per scan / keyframe: server.publish(slam) ...
    server.stop()

Open http://localhost:<port>/ in a browser; /state.json carries the raw
data for external tooling.  No dependencies beyond the standard library;
the publisher thread never touches jax — `publish` runs on the pipeline
thread and performs the (already host-side or single-transfer) reads.
"""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

_PAGE = """<!DOCTYPE html><html><head><title>DMSA live</title></head>
<body style="margin:0;background:#111;color:#ccc;font:12px monospace">
<div id="s" style="position:fixed;left:8px;top:6px"></div>
<canvas id="c" width="1200" height="900" style="display:block;margin:auto"></canvas>
<script>
const c=document.getElementById('c'),g=c.getContext('2d'),st=document.getElementById('s');
async function tick(){
 try{
  const r=await fetch('state.json'); const d=await r.json();
  const pts=d.map||[], sub=d.submap||[], trj=d.trajectory||[], pose=d.pose;
  g.fillStyle='#111';g.fillRect(0,0,1200,900);
  if(pts.length+sub.length+trj.length>1){
   const all=pts.concat(sub).concat(trj);
   const xs=all.map(p=>p[0]), ys=all.map(p=>p[1]);
   const x0=Math.min(...xs),x1=Math.max(...xs),y0=Math.min(...ys),y1=Math.max(...ys);
   const s=Math.min(1100/(x1-x0+1e-6),820/(y1-y0+1e-6));
   const X=x=>50+(x-x0)*s, Y=y=>860-(y-y0)*s;
   g.fillStyle='#6af';for(const p of pts)g.fillRect(X(p[0]),Y(p[1]),1.5,1.5);
   g.fillStyle='#4e4';for(const p of sub)g.fillRect(X(p[0]),Y(p[1]),1.5,1.5);
   g.strokeStyle='#f80';g.lineWidth=2;g.beginPath();
   trj.forEach((p,i)=>i?g.lineTo(X(p[0]),Y(p[1])):g.moveTo(X(p[0]),Y(p[1])));g.stroke();
   if(pose){ // pose axes: x red, y yellow (top-down view)
    const [p,ax,ay]=pose;
    g.lineWidth=2.5;
    g.strokeStyle='#f33';g.beginPath();g.moveTo(X(p[0]),Y(p[1]));g.lineTo(X(ax[0]),Y(ax[1]));g.stroke();
    g.strokeStyle='#ff3';g.beginPath();g.moveTo(X(p[0]),Y(p[1]));g.lineTo(X(ay[0]),Y(ay[1]));g.stroke();
    g.fillStyle='#f33';g.beginPath();g.arc(X(p[0]),Y(p[1]),4,0,7);g.fill();
   }
  }
  st.textContent=`scans ${d.scans}  keyframes ${d.keyframes}  map pts ${pts.length}  submap pts ${sub.length}  t=${d.stamp}`;
 }catch(e){st.textContent='waiting for data... '+e;}
 setTimeout(tick, 1000);
}
tick();
</script></body></html>"""


class LiveViewServer:
    """Threaded HTTP server publishing the latest SLAM state snapshot."""

    def __init__(self, port: int = 8008, max_map_points: int = 20000, host: str = "127.0.0.1"):
        self.port = port
        self.host = host  # loopback by default; pass 0.0.0.0 to expose
        self.max_map_points = max_map_points
        self._lock = threading.Lock()
        self._state_json = json.dumps({"scans": 0, "keyframes": 0, "map": [], "trajectory": []})
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- publish
    def publish(self, slam, scans: int = 0):
        """Snapshot the pipeline state (called from the pipeline thread,
        mirroring publishPointCloudsAndPose, dmsa_slam_ros.cpp:322-372)."""
        pts = slam.map_points()
        if pts is None:
            pts = np.zeros((0, 3))
        pts = np.asarray(pts, dtype=float)
        if len(pts) > self.max_map_points:
            pts = pts[:: len(pts) // self.max_map_points]
        sub = slam.submap_points() if hasattr(slam, "submap_points") else None
        if sub is None:
            sub = np.zeros((0, 3))
        sub = np.asarray(sub, dtype=float)
        if len(sub) > self.max_map_points // 2:
            sub = sub[:: len(sub) // (self.max_map_points // 2)]
        if hasattr(slam, "keyframe_poses"):
            _, transl, _ = slam.keyframe_poses()
        else:
            transl = slam.kf_map.transl_w[: slam.kf_map.count]
        trj = np.asarray(transl, dtype=float).reshape(-1, 3)
        pose = slam.current_pose() if hasattr(slam, "current_pose") else None
        pose_out = None
        if pose is not None:
            from scipy.spatial.transform import Rotation

            p, rv = pose
            R = Rotation.from_rotvec(rv).as_matrix()
            # axis endpoints at 1 m (the reference publishes the pose as a
            # tf frame rendered with axes in RViz)
            pose_out = [
                np.round(p, 3).tolist(),
                np.round(p + R[:, 0], 3).tolist(),
                np.round(p + R[:, 1], 3).tolist(),
            ]
        state = {
            "stamp": round(time.time(), 2),
            "scans": int(scans),
            "keyframes": int(len(trj)),
            "map": np.round(pts, 2).tolist(),
            "submap": np.round(sub, 2).tolist(),
            "pose": pose_out,
            "trajectory": np.round(trj, 3).tolist(),
        }
        blob = json.dumps(state)
        with self._lock:
            self._state_json = blob

    # -------------------------------------------------------------- server
    def start(self):
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path.rstrip("/") in ("", "/index.html"):
                    body, ctype = _PAGE.encode(), "text/html"
                elif self.path.lstrip("/") == "state.json":
                    with srv._lock:
                        body = srv._state_json.encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-request logging
                pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]  # resolves port=0
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
