"""Class adapters over the functional core, for the single-env workflow.

Counterpart of the JAX package's `envs/gym_adapter.py`: drop-in
counterparts of the reference aviaries (same constructor surface,
reference envs/BaseAviary.py:25-40 and subclasses) for users of upstream
gym-pybullet-drones, who start from `CtrlAviary` and `examples/pid.py`.
`core.step` does the work on the state's device (None = the CUDA card);
numpy conversion happens only at this boundary.  Batched training should
use `BatchedEnv` or `envs/fast.py` directly.

The classes are plain Python classes with gymnasium's method surface
(`reset(seed, options) -> (obs, info)`, `step(action) -> (obs, reward,
terminated, truncated, info)`, `action_space` / `observation_space` as
`envs/spaces.Box`), not `gymnasium.Env` subclasses: the port stands
without gymnasium, so it registers no gym ids either.
"""
from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch.params import get_params
from gym_pybullet_drones_tpu_torch.utils.device import resolve_device
from gym_pybullet_drones_tpu_torch.utils.enums import (
    ActionType, DroneModel, ImageType, ObservationType, Physics)
from gym_pybullet_drones_tpu_torch.utils.utils import require
from gym_pybullet_drones_tpu_torch.envs import core, tasks
from gym_pybullet_drones_tpu_torch.envs.spaces import Box
from gym_pybullet_drones_tpu_torch.ops import kernel_render
from gym_pybullet_drones_tpu_torch.ops import render as render_ops
from gym_pybullet_drones_tpu_torch.ops import quat as quat_ops


def _numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class FunctionalAviary:
    """A gym-style env around (cfg, task), stepping `core.step` on `device`
    (None = the CUDA card; raises where there is none)."""

    metadata = {"render_modes": ["human"]}

    def __init__(self, cfg: core.AviaryConfig, task, dtype=torch.float32,
                 record: bool = False, output_folder: str = "results",
                 gui: bool = False, user_debug_gui: bool = True,
                 device=None):
        self.cfg = cfg
        self.task = task
        self.dtype = dtype
        self.device = resolve_device(device)
        # Host-side GUI analogue (reference BaseAviary GUI branch, :148-167):
        # a matplotlib 3D flight view updated per control step — live when an
        # interactive backend exists, otherwise frames accumulate for
        # viewer.save() (utils/viewer.py).
        self.GUI = gui
        self._viewer = None
        # User-debug surface (reference :162-167,318-341,497-499): RPM
        # sliders + "Use GUI RPM" input switch + local-axes overlays; when
        # toggled on, slider RPMs are tiled over all drones and the task's
        # action preprocessing is bypassed (`core.step(rpm_override=...)`),
        # exactly like the reference's USE_GUI_RPM branch skipping
        # _preprocessAction.
        self.USER_DEBUG = user_debug_gui
        self.USE_GUI_RPM = False
        self.last_input_switch = 0
        self.gui_input = np.zeros(4)
        # Frame recording (reference BaseAviary DIRECT-mode PNG capture,
        # :174-192,292-317): ray-traced third-person frames at 24 fps.
        self.RECORD = record
        self.OUTPUT_FOLDER = output_folder
        self.FRAME_PER_SEC = 24
        self.CAPTURE_FREQ = max(1, int(cfg.pyb_freq / self.FRAME_PER_SEC))
        self.FRAME_NUM = 0
        self._record_dir = None
        self.state: core.EnvState | None = None
        self._reset_time = time.time()
        self.np_random = np.random.default_rng()
        self.action_space = self._action_space()
        self.observation_space = self._observation_space()
        # Reference-style constants, exposed for example-script parity
        self.NUM_DRONES = cfg.num_drones
        self.CTRL_FREQ = cfg.ctrl_freq
        self.PYB_FREQ = cfg.pyb_freq
        self.CTRL_TIMESTEP = cfg.ctrl_dt
        self.PYB_TIMESTEP = cfg.pyb_dt
        self.MAX_RPM = cfg.drone.max_rpm
        self.HOVER_RPM = cfg.drone.hover_rpm
        self.INIT_XYZS = _numpy(cfg.default_init_xyzs(torch.float32, "cpu"))
        self.INIT_RPYS = _numpy(cfg.default_init_rpys(torch.float32, "cpu"))

    # -- spaces ---------------------------------------------------------
    def _action_space(self):
        n = self.cfg.num_drones
        if isinstance(self.task, tasks.RLTask):
            size = self.task.action_dim(self.cfg)
            return Box(low=-np.ones((n, size), np.float32),
                       high=np.ones((n, size), np.float32), dtype=np.float32)
        if isinstance(self.task, tasks.VelocityTask):
            low = np.tile([-1, -1, -1, 0], (n, 1)).astype(np.float32)
            high = np.tile([1, 1, 1, 1], (n, 1)).astype(np.float32)
            return Box(low=low, high=high, dtype=np.float32)
        max_rpm = self.cfg.drone.max_rpm
        return Box(low=np.zeros((n, 4), np.float32),
                   high=np.full((n, 4), max_rpm, np.float32),
                   dtype=np.float32)

    def _observation_space(self):
        n = self.cfg.num_drones
        if isinstance(self.task, tasks.RLTask) and \
                self.task.obs == ObservationType.RGB:
            # Reference quirk preserved: the space is declared uint8
            # (BaseRLAviary.py:252-255) while _computeObs returns float32
            # values in [0, 255] (:306); we mirror both sides.
            return Box(low=0, high=255, shape=(n, 48, 64, 4),
                       dtype=np.uint8)
        if isinstance(self.task, tasks.RLTask):
            d = self.task.obs_dim(self.cfg)
            lo = np.full((n, d), -np.inf, np.float32)
            hi = np.full((n, d), np.inf, np.float32)
            lo[:, 2] = 0.0  # z >= 0 (reference BaseRLAviary.py:262)
            lo[:, 12:] = -1.0
            hi[:, 12:] = 1.0
            return Box(low=lo, high=hi, dtype=np.float32)
        max_rpm = self.cfg.drone.max_rpm
        lo = np.array([[-np.inf, -np.inf, 0, -1, -1, -1, -1, -np.pi,
                        -np.pi, -np.pi, -np.inf, -np.inf, -np.inf, -np.inf,
                        -np.inf, -np.inf, 0, 0, 0, 0]] * n, np.float32)
        hi = np.array([[np.inf, np.inf, np.inf, 1, 1, 1, 1, np.pi, np.pi,
                        np.pi, np.inf, np.inf, np.inf, np.inf, np.inf,
                        np.inf, max_rpm, max_rpm, max_rpm, max_rpm]] * n,
                      np.float32)
        return Box(low=lo, high=hi, dtype=np.float32)

    # -- gym API --------------------------------------------------------
    def _reset_state(self):
        # the JAX adapter resets with the default key: a task with reset
        # noise starts from seed 0's draw (core.reset)
        self.state, obs, info = core.reset(self.cfg, self.task, self.dtype,
                                           self.device)
        return obs, info

    def reset(self, seed: int | None = None, options: dict | None = None):
        """(obs, info).  `seed` seeds `np_random`, as gymnasium's reset
        does; the state is the task's reset."""
        if seed is not None:
            self.np_random = np.random.default_rng(seed)
        obs, info = self._reset_state()
        self._reset_time = time.time()
        return _numpy(obs), info

    def step(self, action):
        """(obs, reward: float, terminated: bool, truncated: bool, info);
        `action` (N, A) as numpy or as a tensor (on any device)."""
        if self.state is None:
            # The reference engine is steppable straight after construction
            # (BaseAviary.__init__ runs _housekeeping, :211-214; e.g.
            # examples/beta.py steps without calling reset())
            self._reset_state()
        if self.RECORD and \
                int(self.state.step_counter) % self.CAPTURE_FREQ == 0:
            self._capture_frame()
        # GUI input-switch polling + slider override (reference :318-341):
        # each press of "Use GUI RPM" toggles USE_GUI_RPM; while on, the
        # four slider RPMs are tiled over all drones and applied raw
        if self.GUI and self.USER_DEBUG:
            viewer = self._ensure_viewer()
            cur = viewer.input_switch_count
            if cur > self.last_input_switch:
                self.last_input_switch = cur
                self.USE_GUI_RPM = not self.USE_GUI_RPM
                viewer.show_gui_rpm_text(self.USE_GUI_RPM)
        if self.USE_GUI_RPM:
            self.gui_input = self._viewer.slider_values()
            rpm = torch.as_tensor(
                np.tile(self.gui_input, (self.NUM_DRONES, 1)),
                dtype=self.dtype, device=self.device)
            out = core.step(self.cfg, self.task, self.state, None,
                            rpm_override=rpm)
        else:
            if not isinstance(action, torch.Tensor):
                action = np.asarray(action)
            action = torch.as_tensor(action, dtype=self.dtype,
                                     device=self.device)
            out = core.step(self.cfg, self.task, self.state, action)
        self.state, obs, reward, term, trunc, info = out
        if self.GUI:
            self._update_viewer()
        return (_numpy(obs), float(reward), bool(term), bool(trunc), info)

    def _ensure_viewer(self):
        if self._viewer is None:
            from gym_pybullet_drones_tpu_torch.utils.viewer import \
                FlightViewer
            targets = getattr(self.task, "target_pos", None)
            if targets is None:
                targets = getattr(self, "TARGET_POS", None)
            self._viewer = FlightViewer(
                self.cfg.num_drones, arm=self.cfg.drone.l,
                obstacles=self.cfg.obstacles, targets=targets,
                fps=min(30.0, self.cfg.ctrl_freq),
                user_debug=self.USER_DEBUG,
                max_rpm=self.MAX_RPM, hover_rpm=self.HOVER_RPM)
        return self._viewer

    def _update_viewer(self):
        self._ensure_viewer()
        rpy = quat_ops.quat_to_rpy(self.state.quat)
        self._viewer.update(_numpy(self.state.pos), _numpy(rpy))

    def _capture_frame(self):
        """Save a third-person PNG frame (reference CAM_VIEW: distance 3,
        yaw -30 deg, pitch -30 deg, target the origin; :180-192), rendered
        by the plain ray tracer (`ops/render.py`) on the state's device."""
        Image = require("PIL.Image", "recording frames")
        if self._record_dir is None:
            from datetime import datetime
            self._record_dir = os.path.join(
                self.OUTPUT_FOLDER, "recording_"
                + datetime.now().strftime("%m.%d.%Y_%H.%M.%S"))
            os.makedirs(self._record_dir, exist_ok=True)
        yaw, pitch, dist = np.radians(-30.0), np.radians(-30.0), 3.0
        eye = np.array([dist * np.cos(pitch) * np.cos(yaw),
                        dist * np.cos(pitch) * np.sin(yaw),
                        -dist * np.sin(pitch)])
        forward = -eye / np.linalg.norm(eye)
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(forward, up)
        right /= np.linalg.norm(right)
        cam_up = np.cross(right, forward)
        rot = np.stack([forward, -right, cam_up], axis=-1)  # col0 = forward
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                         device=self.device)
        rgba, _, _ = render_ops.render(
            self.cfg.drone, render_ops.landmark_scene(), as_t(eye), as_t(rot),
            drone_pos=self.state.pos.float(), width=160, height=120)
        Image.fromarray(_numpy(rgba).astype("uint8"), "RGBA").save(
            os.path.join(self._record_dir, f"frame_{self.FRAME_NUM}.png"))
        self.FRAME_NUM += 1

    def render(self):
        """Text render with real-time factor (reference
        BaseAviary.py:387-412)."""
        sc = int(self.state.step_counter)
        wall = time.time() - self._reset_time
        sim_t = sc * self.cfg.pyb_dt
        print(f"[INFO] it {sc:04d} --- wall-clock {wall:.1f}s, "
              f"sim time {sim_t:.1f}s@{self.cfg.pyb_freq}Hz "
              f"({sim_t / max(wall, 1e-9):.2f}x)")

    def close(self):
        if self._viewer is not None:
            self._viewer.close()
            self._viewer = None
        if self.RECORD and self._record_dir is not None:
            # assemble the PNG frames into a playable video (counterpart
            # of the reference's mp4 state logging, BaseAviary.py:523-537)
            from gym_pybullet_drones_tpu_torch.utils.video import \
                assemble_frame_dir
            # frames are only captured when the step counter (advancing by
            # steps_per_ctrl per env step) lands on a CAPTURE_FREQ multiple,
            # so the EFFECTIVE interval is lcm(CAPTURE_FREQ, steps_per_ctrl)
            # substeps — using the nominal CAPTURE_FREQ here would play the
            # video up to steps_per_ctrl/gcd times too fast
            interval = math.lcm(self.CAPTURE_FREQ, self.cfg.steps_per_ctrl)
            out = assemble_frame_dir(
                self._record_dir, fps=self.cfg.pyb_freq / interval)
            if out:
                print(f"[INFO] recording assembled: {out}")

    # -- extras mirroring reference helpers -----------------------------
    def getPyBulletClient(self):
        """Reference-API stub: there is no PyBullet client; returns None so
        drop-in scripts keep working."""
        return None

    def getDroneIds(self) -> np.ndarray:
        """Drone indices 0..N-1 (reference BaseAviary.getDroneIds)."""
        return np.arange(self.cfg.num_drones)

    def getDroneStateVector(self, nth_drone: int) -> np.ndarray:
        return _numpy(core.state_vector(self.state)[nth_drone])

    def getDroneImages(self, nth_drone: int, segmentation: bool = True):
        """Drone `nth_drone`'s camera: (rgba (48, 64, 4) in [0, 255], depth
        (48, 64), seg (48, 64) int32), as numpy (reference
        BaseAviary._getDroneImages:565-617).  One launch of the render
        kernel for every drone's camera on the card
        (`kernel_render.render_drones`, with its depth and seg outputs);
        its plain version on the CPU."""
        h, w, _ = render_ops.IMAGE_SHAPE
        rgba, depth, seg = kernel_render.render_drones(
            self.cfg.drone, render_ops.landmark_scene(), self.state.pos,
            self.state.quat, self.cfg.num_drones, w, h, depth_seg=True)
        return (_numpy(rgba[nth_drone].reshape(h, w, 4)),
                _numpy(depth[nth_drone]), _numpy(seg[nth_drone]))

    def exportImage(self, img_input, path: str, frame_num: int = 0,
                    img_type=None):
        """Save an RGB(A)/depth/seg capture as PNG
        (reference BaseAviary._exportImage:621-654)."""
        Image = require("PIL.Image", "exportImage")
        img_type = ImageType.RGB if img_type is None else img_type
        os.makedirs(path, exist_ok=True)
        out = os.path.join(path, f"frame_{frame_num}.png")
        arr = np.asarray(img_input)
        if img_type == ImageType.RGB:
            Image.fromarray(arr.astype("uint8"), "RGBA").save(out)
        elif img_type == ImageType.BW:
            Image.fromarray(
                (np.sum(arr[:, :, 0:2], axis=2) / 3).astype("uint8")
            ).save(out)
        else:  # DEP / SEG: normalize to 0..255 grayscale
            lo, hi = float(np.min(arr)), float(np.max(arr))
            scaled = (arr - lo) * 255 / max(hi - lo, 1e-9)
            Image.fromarray(scaled.astype("uint8")).save(out)
        return out

    def getAdjacencyMatrix(self) -> np.ndarray:
        return _numpy(core.adjacency_matrix(self.cfg, self.state))


# The reference's obstacle bodies (BaseAviary._addObstacles:955-978:
# duck/cube/sphere around the origin) as collision primitives: the duck
# mesh by its bounding sphere, cube_no_rotation as a true 1 m box, sphere2
# as its exact sphere.  4-tuple = sphere, 6-tuple = box (center + half
# extents) — see envs/core.AviaryConfig.obstacles.  The JAX package's
# values.
OBSTACLE_SPHERES = (
    (-0.5, -0.5, 0.05, 0.06),           # duck (bounding sphere)
    (-0.5, -2.5, 0.5, 0.5, 0.5, 0.5),   # cube_no_rotation (1 m box)
    (0.0, 2.0, 0.5, 0.5),               # sphere2
)


def _make_cfg(drone_model, num_drones, neighbourhood_radius, initial_xyzs,
              initial_rpys, physics, pyb_freq, ctrl_freq, obstacles=False):
    to_tuple = lambda a: None if a is None else tuple(
        tuple(float(v) for v in row) for row in np.asarray(a))
    return core.AviaryConfig(
        drone=get_params(drone_model), num_drones=num_drones,
        physics=Physics(physics), pyb_freq=pyb_freq, ctrl_freq=ctrl_freq,
        neighbourhood_radius=float(neighbourhood_radius),
        init_xyzs=to_tuple(initial_xyzs), init_rpys=to_tuple(initial_rpys),
        obstacles=OBSTACLE_SPHERES if obstacles else ())


class CtrlAviary(FunctionalAviary):
    """Direct-RPM control env (reference envs/CtrlAviary.py)."""

    def __init__(self, drone_model=DroneModel.CF2X, num_drones=1,
                 neighbourhood_radius=np.inf, initial_xyzs=None,
                 initial_rpys=None, physics=Physics.PYB, pyb_freq=240,
                 ctrl_freq=240, gui=False, record=False, obstacles=False,
                 user_debug_gui=True, output_folder="results", device=None,
                 **kw):
        cfg = _make_cfg(drone_model, num_drones, neighbourhood_radius,
                        initial_xyzs, initial_rpys, physics, pyb_freq,
                        ctrl_freq, obstacles=obstacles)
        super().__init__(cfg, tasks.CtrlTask(), record=record,
                         output_folder=output_folder, gui=gui,
                         user_debug_gui=user_debug_gui, device=device)


class VelocityAviary(FunctionalAviary):
    """Velocity-command env (reference envs/VelocityAviary.py)."""

    def __init__(self, drone_model=DroneModel.CF2X, num_drones=1,
                 neighbourhood_radius=np.inf, initial_xyzs=None,
                 initial_rpys=None, physics=Physics.PYB, pyb_freq=240,
                 ctrl_freq=240, gui=False, record=False, obstacles=False,
                 user_debug_gui=True, output_folder="results", device=None,
                 **kw):
        cfg = _make_cfg(drone_model, num_drones, neighbourhood_radius,
                        initial_xyzs, initial_rpys, physics, pyb_freq,
                        ctrl_freq, obstacles=obstacles)
        super().__init__(cfg, tasks.VelocityTask(), record=record,
                         output_folder=output_folder, gui=gui,
                         user_debug_gui=user_debug_gui, device=device)


class HoverAviary(FunctionalAviary):
    """Single-agent hover RL env (reference envs/HoverAviary.py)."""

    def __init__(self, drone_model=DroneModel.CF2X, initial_xyzs=None,
                 initial_rpys=None, physics=Physics.PYB, pyb_freq=240,
                 ctrl_freq=30, gui=False, record=False,
                 obs=ObservationType.KIN, act=ActionType.RPM, device=None,
                 **kw):
        cfg = _make_cfg(drone_model, 1, np.inf, initial_xyzs, initial_rpys,
                        physics, pyb_freq, ctrl_freq)
        task = tasks.HoverTask(act=ActionType(act), obs=ObservationType(obs))
        super().__init__(cfg, task, record=record, gui=gui, device=device)
        self.EPISODE_LEN_SEC = task.episode_len_sec
        self.TARGET_POS = np.asarray(task.target_pos)


class MultiHoverAviary(FunctionalAviary):
    """Multi-agent hover RL env (reference envs/MultiHoverAviary.py)."""

    def __init__(self, drone_model=DroneModel.CF2X, num_drones=2,
                 neighbourhood_radius=np.inf, initial_xyzs=None,
                 initial_rpys=None, physics=Physics.PYB, pyb_freq=240,
                 ctrl_freq=30, gui=False, record=False,
                 obs=ObservationType.KIN, act=ActionType.RPM, device=None,
                 **kw):
        cfg = _make_cfg(drone_model, num_drones, neighbourhood_radius,
                        initial_xyzs, initial_rpys, physics, pyb_freq,
                        ctrl_freq)
        task = tasks.MultiHoverTask(act=ActionType(act),
                                    obs=ObservationType(obs))
        super().__init__(cfg, task, record=record, gui=gui, device=device)
        self.EPISODE_LEN_SEC = task.episode_len_sec
        self.TARGET_POS = _numpy(task._targets(
            cfg, torch.zeros((), dtype=torch.float32)))


class BatchedEnv:
    """A batch of identical envs with auto-reset, on one device.

    The replacement of SB3's DummyVecEnv (SURVEY.md §2.4): leaves carry a
    leading env axis, (num_envs, N, k), and one `core.step_autoreset`
    advances all envs.  A task with reset noise draws every env's reset
    from a CPU `torch.Generator` that `reset(seed)` seeds, one draw for
    every env each step (`core.step_autoreset`).  For throughput use
    `envs/fast.make_batched_step`.
    """

    def __init__(self, cfg: core.AviaryConfig, task, num_envs: int,
                 dtype=torch.float32, device=None):
        self.cfg, self.task, self.num_envs = cfg, task, num_envs
        self.dtype = dtype
        self.device = resolve_device(device)
        self.generator = torch.Generator().manual_seed(0)

    def reset(self, seed: int = 0):
        """(state, obs (num_envs, N, D)); `seed` seeds the reset noise."""
        self.generator = torch.Generator().manual_seed(int(seed))
        state, obs, _ = core.reset(self.cfg, self.task, self.dtype,
                                   self.device, generator=self.generator,
                                   batch_shape=(self.num_envs,))
        return state, obs

    def step(self, state, action):
        """action: (num_envs, N, A) -> (state, obs, reward, term, trunc)."""
        state, obs, r, te, tr, _ = core.step_autoreset(
            self.cfg, self.task, state,
            torch.as_tensor(action, dtype=self.dtype, device=self.device),
            generator=self.generator)
        return state, obs, r, te, tr
