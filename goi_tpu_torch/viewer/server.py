"""SIBR-compatible remote viewer protocol server.

Counterpart of goi_tpu/viewer/server.py, wire-format-compatible with
ref:gaussian_renderer/network_gui.py:24-86: a non-blocking TCP listener;
requests are 4-byte little-endian length-prefixed JSON carrying the
resolution, fovs, view/projection matrices (row-vector convention, Y/Z
flipped) and training flags; replies are raw HxWx3 bytes followed by a
length-prefixed verification string. Cameras are built on `device`.
`request_frame` is the client side of one exchange.
"""

from __future__ import annotations

import json
import math
import socket
from typing import Optional, Tuple

import numpy as np
import torch

from goi_tpu_torch.core.camera import Camera


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009,
                 device="cuda"):
        self.host = host
        self.port = port
        self.device = torch.device(device)
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn: Optional[socket.socket] = None

    def try_connect(self) -> bool:
        if self.conn is not None:
            return True
        try:
            self.conn, addr = self.listener.accept()
            self.conn.settimeout(None)
            print(f"\nConnected by {addr}", flush=True)
            return True
        except (BlockingIOError, socket.timeout, OSError):
            return False

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def receive(self) -> Tuple[Optional[Camera], dict]:
        """(camera or None, flags), with the reference's message fields
        and Y/Z column flips (ref:network_gui.py:57-86)."""
        length = int.from_bytes(self._read_exact(4), "little")
        msg = json.loads(self._read_exact(length).decode("utf-8"))

        width = msg["resolution_x"]
        height = msg["resolution_y"]
        flags = {
            "train": bool(msg.get("train", False)),
            "shs_python": bool(msg.get("shs_python", False)),
            "rot_scale_python": bool(msg.get("rot_scale_python", False)),
            "keep_alive": bool(msg.get("keep_alive", True)),
            "scaling_modifier": msg.get("scaling_modifier", 1.0),
        }
        if width == 0 or height == 0:
            return None, flags

        # wire matrices are the transposed (row-vector) forms with the
        # SIBR viewer's Y/Z sign convention
        wv = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
        wv[:, 1] = -wv[:, 1]
        wv[:, 2] = -wv[:, 2]
        fp = np.array(msg["view_projection_matrix"], np.float32).reshape(4, 4)
        fp[:, 1] = -fp[:, 1]
        world_view = wv.T          # -> math (column-vector) W2C
        full_proj = fp.T

        def t32(a):
            return torch.as_tensor(np.float32(a), device=self.device)

        cam = Camera(world_view=t32(world_view), full_proj=t32(full_proj),
                     camera_center=t32(np.linalg.inv(world_view)[:3, 3]),
                     tan_fovx=t32(math.tan(msg["fov_x"] * 0.5)),
                     tan_fovy=t32(math.tan(msg["fov_y"] * 0.5)),
                     width=int(width), height=int(height))
        return cam, flags

    def send(self, image: Optional[np.ndarray], verify: str) -> None:
        """image: (H, W, 3) uint8 or None (ref:network_gui.py:50-55)."""
        if image is not None:
            self.conn.sendall(np.ascontiguousarray(image).tobytes())
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def drop(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            finally:
                self.conn = None

    def close(self) -> None:
        self.drop()
        self.listener.close()

    def serve_step(self, render_fn, verify: str) -> dict:
        """One poll/serve iteration (the role of the training loop's
        network_gui block, ref:train.py:97-111): accept a pending
        connection, render the requested view with
        render_fn(cam, scaling_modifier) -> (3, H, W) or (H, W, 3) image
        (float in [0, 1] or uint8, array or tensor), reply; a socket
        error drops the connection. Returns the request's flags ({} when
        no request was served)."""
        from goi_tpu_torch.viewer.web import _as_u8_hwc

        flags = {}
        if not self.try_connect():
            return flags
        try:
            cam, flags = self.receive()
            img = None
            if cam is not None:
                img = _as_u8_hwc(render_fn(cam, flags["scaling_modifier"]))
            self.send(img, verify)
        except (ConnectionError, OSError, json.JSONDecodeError):
            self.drop()
        return flags


def request_message(cam: Camera, scaling_modifier: float = 1.0) -> bytes:
    """The length-prefixed request a SIBR viewer sends for `cam`: its
    matrices in the wire's row-vector form with the Y/Z flips that
    `NetworkGUI.receive` undoes, so the server rebuilds `cam` bit for
    bit."""
    wv = cam.world_view.cpu().numpy().T.copy()
    wv[:, 1] = -wv[:, 1]
    wv[:, 2] = -wv[:, 2]
    fp = cam.full_proj.cpu().numpy().T.copy()
    fp[:, 1] = -fp[:, 1]
    msg = json.dumps({
        "resolution_x": cam.width, "resolution_y": cam.height,
        "train": False, "fov_x": 2 * math.atan(float(cam.tan_fovx)),
        "fov_y": 2 * math.atan(float(cam.tan_fovy)), "z_near": 0.01,
        "z_far": 100.0, "shs_python": False, "rot_scale_python": False,
        "keep_alive": True, "scaling_modifier": scaling_modifier,
        "view_matrix": wv.reshape(-1).tolist(),
        "view_projection_matrix": fp.reshape(-1).tolist()}).encode()
    return len(msg).to_bytes(4, "little") + msg


def request_frame(host: str, port: int, cam: Camera,
                  timeout: float = 60.0) -> Tuple[np.ndarray, str]:
    """Connect, request `cam`'s view, and return the reply: the (H, W, 3)
    uint8 frame and the verification string."""
    def read(s, n):
        buf = b""
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed the connection")
            buf += chunk
        return buf

    with socket.create_connection((host, port), timeout=timeout) as s:
        s.sendall(request_message(cam))
        img = read(s, cam.height * cam.width * 3)
        verify = read(s, int.from_bytes(read(s, 4), "little"))
    frame = np.frombuffer(img, np.uint8).reshape(cam.height, cam.width, 3)
    return frame, verify.decode("ascii")
