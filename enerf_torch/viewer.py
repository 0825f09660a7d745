"""Interactive viewer: orbit camera, interleaved train / render, web UI.

Counterpart of enerf_tpu/viewer.py (reference nerf/gui.py: OrbitCamera
:10-60, the render loop that interleaves 16 training steps with
progressive-SPP preview renders, trainer.train_gui / test_gui
utils.py:807-918, and dynamic resolution against a per-frame time budget,
gui.py:119-148, 200 ms by default).

The display is a dependency-free HTTP server (stdlib `http.server`) that
serves PNG frames through the port's own codec (utils/png.py): drag to
orbit, scroll to zoom.  `TurntableRecorder` writes an orbit's frames to
disk, the non-interactive viewer.  Rendering and training run on the
trainer's device (`Trainer.render_view`, `Trainer.train_step`).
"""

import math
import os
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np

from enerf_torch.utils.png import encode_png, write_png


def _to8(img):
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


class OrbitCamera:
    """Orbit camera with the reference's pose convention (gui.py:10-60)."""

    def __init__(self, W, H, r=5.0, fovy=50.0):
        self.W, self.H = W, H
        self.radius = r
        self.fovy = fovy
        self.center = np.zeros(3, np.float64)
        self.yaw = 0.0
        self.pitch = 0.0

    @property
    def intrinsics(self):
        focal = self.H / (2.0 * math.tan(math.radians(self.fovy) / 2.0))
        return (focal, focal, self.W / 2.0, self.H / 2.0)

    @property
    def pose(self):
        """c2w [4, 4], right-down-forward (matches data/rays.py)."""
        cy, sy = math.cos(self.yaw), math.sin(self.yaw)
        cp, sp = math.cos(self.pitch), math.sin(self.pitch)
        eye = self.center + self.radius * np.asarray([cy * cp, sy * cp, sp])
        f = self.center - eye
        f = f / np.linalg.norm(f)
        up = np.asarray([0.0, 0.0, 1.0])
        r = np.cross(f, up)
        r = r / max(np.linalg.norm(r), 1e-9)
        d = np.cross(f, r)
        pose = np.eye(4)
        pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = r, d, f, eye
        return pose

    def orbit(self, dx, dy):
        self.yaw += 2.0 * math.pi * dx / self.W
        self.pitch = float(np.clip(self.pitch + math.pi * dy / self.H, -1.5, 1.5))

    def scale(self, delta):
        self.radius *= 1.1 ** (-delta)

    def pan(self, dx, dy, dz=0.0):
        p = self.pose
        self.center += 5e-4 * (p[:3, :3] @ np.asarray([dx, dy, dz])) * self.radius


class GUIRenderer:
    """Interleaved training and progressive preview (reference train_gui /
    test_gui, utils.py:807-918, and gui.py:119-148)."""

    def __init__(self, trainer, provider=None, W=640, H=360, radius=5.0, fovy=50.0,
                 max_spp=64, frame_budget_ms=200.0):
        self.trainer = trainer
        self.provider = provider
        self.cam = OrbitCamera(W, H, r=radius, fovy=fovy)
        self.max_spp = max_spp
        self.frame_budget_ms = frame_budget_ms
        self.downscale = 1.0
        self.spp = 0
        self._accum = None
        self._seen_shapes = set()
        self.training = provider is not None

    def train_steps(self, n=16):
        """n training steps through Trainer.train_step (the occupancy grid
        kept live on its 16-step cadence); returns the mean loss.  The model
        changed, so the progressive accumulation restarts (reference gui.py
        sets need_update after training)."""
        losses = [float(self.trainer.train_step(self.provider)["loss"]) for _ in range(n)]
        self.reset_view()
        return float(np.mean(losses))

    def reset_view(self):
        self.spp = 0
        self._accum = None

    def render_frame(self):
        """One preview frame with progressive SPP accumulation and dynamic
        resolution against the frame budget.  Returns [H, W, C] float."""
        t0 = time.time()
        H = max(int(self.cam.H * self.downscale) // 8 * 8, 16)
        W = max(int(self.cam.W * self.downscale) // 8 * 8, 16)
        cam = OrbitCamera(W, H, self.cam.radius, self.cam.fovy)
        img, _ = self.trainer.render_view(self.cam.pose, cam.intrinsics, H, W)
        dt_ms = (time.time() - t0) * 1000.0
        # the first frame at a new resolution may pay one-time costs (kernel
        # builds, allocator growth): only later frames inform the controller
        seen = (H, W) in self._seen_shapes
        self._seen_shapes.add((H, W))
        if self._accum is None or self._accum.shape[:2] != (H, W):
            self._accum = img
            self.spp = 1
        elif self.spp < self.max_spp:
            self._accum = (self._accum * self.spp + img) / (self.spp + 1)
            self.spp += 1
        # dynamic downscale in [1/4, 1] (gui.py:131-140)
        if self.spp <= 1 and seen:
            ratio = self.frame_budget_ms / max(dt_ms, 1e-3)
            self.downscale = float(np.clip(self.downscale * math.sqrt(ratio), 0.25, 1.0))
        return self._accum


class TurntableRecorder:
    """Headless orbit recording (the non-interactive viewer)."""

    def __init__(self, trainer, W=320, H=180, radius=4.0, fovy=50.0):
        self.trainer = trainer
        self.W, self.H = W, H
        self.radius = radius
        self.fovy = fovy

    def record(self, out_dir, n_frames=30):
        """n_frames views around the orbit as <out_dir>/<i:04d>.png."""
        os.makedirs(out_dir, exist_ok=True)
        cam = OrbitCamera(self.W, self.H, self.radius, self.fovy)
        for i in range(n_frames):
            cam.yaw = 2.0 * math.pi * i / n_frames
            img, _ = self.trainer.render_view(cam.pose, cam.intrinsics, self.H, self.W)
            write_png(os.path.join(out_dir, f"{i:04d}.png"), _to8(img))
        return out_dir


def make_viewer_server(gui, host="127.0.0.1", port=7007):
    """The viewer's HTTP server, bound but not serving (port 0: any free
    port, `server.server_address[1]`).  GET / is the page, GET /frame one
    PNG frame (16 training steps first while training), GET
    /orbit?dx=&dy=&dz= moves the camera.  One request at a time: the
    GUIRenderer is not shared between threads."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, body, ctype):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/frame"):
                if gui.training:
                    gui.train_steps(16)
                self._send(encode_png(_to8(gui.render_frame())), "image/png")
            elif self.path.startswith("/orbit"):
                q = urllib.parse.parse_qs(urllib.parse.urlsplit(self.path).query)
                gui.cam.orbit(float(q.get("dx", [0])[0]), float(q.get("dy", [0])[0]))
                gui.cam.scale(float(q.get("dz", [0])[0]))
                gui.reset_view()
                self._send(b"", "text/plain")
            else:
                self._send(_VIEWER_HTML.encode(), "text/html")

    return HTTPServer((host, port), Handler)


def serve_web_viewer(gui, host="127.0.0.1", port=7007):
    """Serve the viewer until interrupted (blocks)."""
    server = make_viewer_server(gui, host, port)
    print(f"viewer at http://{host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


_VIEWER_HTML = """<!doctype html><html><body style="margin:0;background:#111">
<img id=v style="width:100vw;height:100vh;object-fit:contain">
<script>
const v=document.getElementById('v');let drag=false,lx=0,ly=0;
v.onmousedown=e=>{drag=true;lx=e.x;ly=e.y};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(drag){fetch(`/orbit?dx=${e.x-lx}&dy=${e.y-ly}`);lx=e.x;ly=e.y}};
window.onwheel=e=>fetch(`/orbit?dz=${e.deltaY>0?-1:1}`);
(async function loop(){while(true){v.src='/frame?'+Date.now();
await new Promise(r=>{v.onload=r;v.onerror=r});}})();
</script></body></html>"""
