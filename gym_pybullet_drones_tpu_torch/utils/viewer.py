"""Host-side 3D flight viewer — the stand-in for PyBullet's GUI.

The reference opens Bullet's OpenGL debug GUI (reference BaseAviary.py:148-167)
with drone bodies, RGB/depth/seg preview panes, and debug lines for the local
axes (:915-951).  A simulation on an accelerator has no GL context attached
to the physics engine, so the equivalent surface is a host-side matplotlib
3D scene fed by the (host-fetched) simulation state:

- **live mode** (interactive matplotlib backend): the figure redraws as
  ``update()`` is called, throttled to ``fps``; pair with
  ``utils.utils.sync`` for wall-clock pacing exactly like the reference GUI
  loop (reference examples/pid.py:170-173).
- **offline mode** (default on headless hosts): frames accumulate and
  ``save()`` writes an MP4 (ffmpeg) or GIF (pillow) animation; nothing is
  drawn until then.

The viewer draws each drone as an X-quadrotor glyph (two arm segments,
rotated by the drone's yaw/pitch/roll), its recent trail, optional target
markers, and the static obstacle primitives of
``envs.core.AviaryConfig.obstacles`` (spheres and boxes).  Own copy of the
JAX package's `utils/viewer.py`.
"""
from __future__ import annotations

import math

import numpy as np

from gym_pybullet_drones_tpu_torch.utils.utils import require

# matplotlib is imported lazily so importing the package never requires a
# display; Agg is used automatically on headless hosts.


def _euler_to_mat(rpy):
    """XYZ-extrinsic (roll, pitch, yaw) -> rotation matrix, (..., 3, 3)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    row0 = np.stack([cy * cp, cy * sp * sr - sy * cr,
                     cy * sp * cr + sy * sr], -1)
    row1 = np.stack([sy * cp, sy * sp * sr + cy * cr,
                     sy * sp * cr - cy * sr], -1)
    row2 = np.stack([-sp, cp * sr, cp * cr], -1)
    return np.stack([row0, row1, row2], -2)


class FlightViewer:
    """Live/offline 3D visualization of a multi-drone flight.

    Parameters
    ----------
    num_drones : int
    arm : float
        Arm length used for the drone glyph (DroneParams.l).
    obstacles : tuple
        Static obstacle primitives ((x, y, z, r) spheres or
        (x, y, z, hx, hy, hz) boxes), drawn once.
    targets : (N, 3) array or None
        Static target markers (e.g. hover targets).
    fps : float
        Max redraw rate in live mode / playback rate of saved animations.
    trail : int
        Number of past positions kept per drone for the trail line.
    show : bool or None
        Force live drawing on/off; None = auto-detect an interactive
        matplotlib backend.
    user_debug : bool
        Add the reference's user-debug GUI surface (BaseAviary.py:162-167,
        497-499): four "Propeller i RPM" sliders in [0, max_rpm]
        initialized at hover_rpm, a "Use GUI RPM" input-switch button whose
        press count the env polls to toggle slider-driven flight, and RGB
        local-axes overlays of length 2*arm on every drone
        (_showDroneLocalAxes, :915-951).  The widgets are real matplotlib
        widgets in live mode and remain fully driveable programmatically
        (``set_slider`` / ``press_input_switch``) on headless backends.
    max_rpm, hover_rpm : float
        Slider range/initial value (only used with ``user_debug``).
    """

    def __init__(self, num_drones: int, arm: float = 0.0397,
                 obstacles: tuple = (), targets=None, fps: float = 30.0,
                 trail: int = 300, bounds: float = 2.0, show=None,
                 user_debug: bool = False, max_rpm: float = 30000.0,
                 hover_rpm: float = 15000.0):
        matplotlib = require("matplotlib", "FlightViewer")
        if show is None:
            backend = matplotlib.get_backend().lower()
            show = not ("agg" in backend or "template" in backend)
        import matplotlib.pyplot as plt
        self._plt = plt
        self.num_drones = num_drones
        self.arm = arm
        self.fps = fps
        self.trail = trail
        self.show = show
        self._frames: list[tuple[np.ndarray, np.ndarray]] = []
        self._trails = [[] for _ in range(num_drones)]
        self._last_draw = 0.0

        self.fig = plt.figure(figsize=(7, 7))
        self.ax = self.fig.add_subplot(projection="3d")
        self.ax.set_xlabel("x [m]")
        self.ax.set_ylabel("y [m]")
        self.ax.set_zlabel("z [m]")
        self.ax.set_xlim(-bounds, bounds)
        self.ax.set_ylim(-bounds, bounds)
        self.ax.set_zlim(0, 2 * bounds)
        self._draw_static(obstacles, targets)
        cmap = plt.get_cmap("tab10")
        self._colors = [cmap(i % 10) for i in range(num_drones)]
        # two arm segments + trail per drone
        self._arm_lines = []
        self._trail_lines = []
        for i in range(num_drones):
            a1, = self.ax.plot([], [], [], "-", lw=2, c=self._colors[i])
            a2, = self.ax.plot([], [], [], "-", lw=2, c=self._colors[i])
            tr, = self.ax.plot([], [], [], "-", lw=0.7, alpha=0.5,
                               c=self._colors[i])
            self._arm_lines.append((a1, a2))
            self._trail_lines.append(tr)

        # -- user-debug surface (reference BaseAviary.py:162-167,497-499) --
        self.user_debug = user_debug
        self._sliders = []
        self._input_switch_count = 0
        self._axes_lines = []
        self._gui_rpm_text = None
        if user_debug:
            from matplotlib.widgets import Slider, Button
            # make room for the widget column under the 3D axes
            self.fig.subplots_adjust(bottom=0.28)
            for i in range(4):
                sax = self.fig.add_axes([0.25, 0.20 - 0.045 * i, 0.55, 0.03])
                self._sliders.append(Slider(
                    sax, f"Propeller {i} RPM", 0.0, max_rpm,
                    valinit=hover_rpm))
            bax = self.fig.add_axes([0.25, 0.005, 0.25, 0.035])
            self._switch_btn = Button(bax, "Use GUI RPM")
            self._switch_btn.on_clicked(
                lambda _ev: self.press_input_switch())
            # RGB local-axes overlays, one triple per drone
            # (_showDroneLocalAxes: X red, Y green, Z blue, length 2*L)
            for _ in range(num_drones):
                lx, = self.ax.plot([], [], [], "-", lw=1, c="red")
                ly, = self.ax.plot([], [], [], "-", lw=1, c="green")
                lz, = self.ax.plot([], [], [], "-", lw=1, c="blue")
                self._axes_lines.append((lx, ly, lz))
        if self.show:
            plt.ion()
            self.fig.show()

    # -- user-debug parameter surface ------------------------------------
    def slider_values(self) -> np.ndarray:
        """Current values of the 4 RPM sliders (readUserDebugParameter)."""
        return np.array([s.val for s in self._sliders], np.float64)

    def set_slider(self, i: int, value: float):
        """Programmatically move slider i (headless counterpart of a drag)."""
        self._sliders[i].set_val(value)

    def press_input_switch(self):
        """Register one press of the "Use GUI RPM" button.

        The reference's switch is an addUserDebugParameter button whose
        read value counts presses (BaseAviary.py:167,319-323); the env
        polls `input_switch_count` and toggles USE_GUI_RPM on increments.
        """
        self._input_switch_count += 1

    @property
    def input_switch_count(self) -> int:
        return self._input_switch_count

    def show_gui_rpm_text(self, on: bool):
        """Red "Using GUI RPM" overlay (reference addUserDebugText, :329)."""
        if on and self._gui_rpm_text is None:
            self._gui_rpm_text = self.fig.text(
                0.02, 0.95, "Using GUI RPM", color="red", fontsize=12)
        elif not on and self._gui_rpm_text is not None:
            self._gui_rpm_text.remove()
            self._gui_rpm_text = None

    # -- static scene ----------------------------------------------------
    def _draw_static(self, obstacles, targets):
        ax = self.ax
        for entry in obstacles:
            if len(entry) == 4:
                ox, oy, oz, r = entry
                u = np.linspace(0, 2 * math.pi, 16)
                v = np.linspace(0, math.pi, 12)
                xs = ox + r * np.outer(np.cos(u), np.sin(v))
                ys = oy + r * np.outer(np.sin(u), np.sin(v))
                zs = oz + r * np.outer(np.ones_like(u), np.cos(v))
                ax.plot_surface(xs, ys, zs, color="0.6", alpha=0.3,
                                linewidth=0)
            else:
                ox, oy, oz, hx, hy, hz = entry
                corners = np.array(
                    [[sx * hx, sy * hy, sz * hz]
                     for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
                corners += np.array([ox, oy, oz])
                edges = [(0, 1), (0, 2), (0, 4), (3, 1), (3, 2), (3, 7),
                         (5, 1), (5, 4), (5, 7), (6, 2), (6, 4), (6, 7)]
                for a, b in edges:
                    ax.plot(*zip(corners[a], corners[b]), c="0.5", lw=1)
        if targets is not None:
            t = np.asarray(targets).reshape(-1, 3)
            ax.scatter(t[:, 0], t[:, 1], t[:, 2], marker="x", c="red", s=40)

    # -- per-step update -------------------------------------------------
    def update(self, pos, rpy=None):
        """Record one frame.  pos (N, 3); rpy (N, 3) optional (glyph tilt)."""
        pos = np.asarray(pos, np.float64).reshape(self.num_drones, 3)
        if rpy is None:
            rpy = np.zeros((self.num_drones, 3))
        rpy = np.asarray(rpy, np.float64).reshape(self.num_drones, 3)
        self._frames.append((pos.copy(), rpy.copy()))
        for i in range(self.num_drones):
            self._trails[i].append(pos[i])
            if len(self._trails[i]) > self.trail:
                self._trails[i].pop(0)
        if self.show:
            import time
            now = time.time()
            if now - self._last_draw >= 1.0 / self.fps:
                self._draw(pos, rpy)
                self._last_draw = now

    def _draw(self, pos, rpy):
        rot = _euler_to_mat(rpy)                    # (N, 3, 3)
        s = 2.5 * self.arm
        arm1 = np.einsum("nij,j->ni", rot, np.array([s, s, 0.0]))
        arm2 = np.einsum("nij,j->ni", rot, np.array([s, -s, 0.0]))
        for i in range(self.num_drones):
            for line, a in ((self._arm_lines[i][0], arm1[i]),
                            (self._arm_lines[i][1], arm2[i])):
                seg = np.stack([pos[i] - a, pos[i] + a])
                line.set_data(seg[:, 0], seg[:, 1])
                line.set_3d_properties(seg[:, 2])
            tr = np.asarray(self._trails[i])
            self._trail_lines[i].set_data(tr[:, 0], tr[:, 1])
            self._trail_lines[i].set_3d_properties(tr[:, 2])
            if self._axes_lines:
                # body local axes, length 2*L (reference _showDroneLocalAxes)
                for k, line in enumerate(self._axes_lines[i]):
                    tip = pos[i] + rot[i, :, k] * (2.0 * self.arm)
                    seg = np.stack([pos[i], tip])
                    line.set_data(seg[:, 0], seg[:, 1])
                    line.set_3d_properties(seg[:, 2])
        if self.show:
            self.fig.canvas.draw_idle()
            self.fig.canvas.flush_events()

    # -- offline export ---------------------------------------------------
    def save(self, path: str, every: int = 1):
        """Render the recorded frames to an animation file.

        ``.mp4`` needs ffmpeg; ``.gif`` uses pillow (always available).
        ``every`` subsamples frames (e.g. ctrl_freq//fps).
        """
        from matplotlib import animation
        frames = self._frames[::max(1, every)]
        if not frames:
            raise ValueError("no frames recorded")
        # replay trails from scratch so saved playback matches live view
        trails = [[] for _ in range(self.num_drones)]

        def render_frame(k):
            pos, rpy = frames[k]
            for i in range(self.num_drones):
                trails[i].append(pos[i])
                if len(trails[i]) > self.trail:
                    trails[i].pop(0)
            self._trails = trails
            self._draw(pos, rpy)
            return [ln for pair in self._arm_lines for ln in pair]

        anim = animation.FuncAnimation(
            self.fig, render_frame, frames=len(frames),
            interval=1000.0 / self.fps, blit=False)
        if path.endswith(".gif"):
            anim.save(path, writer=animation.PillowWriter(fps=int(self.fps)))
        else:
            anim.save(path, fps=int(self.fps))
        return path

    def close(self):
        self._plt.close(self.fig)
